#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card.

Usage, from the repository root:

    python3 chip_smoke.py [--n N] [--queries Q] [--hard-n N] [--gist-n N]
                          [--int8-n N] [--codec-n N] [--int8-nodes-n N]
    python3 chip_smoke.py --multihost-only   # phase 4's multi-process part
    python3 chip_smoke.py --ab-only [--gist-scale-n N]   # the A/B scripts

Phases (each raises on failure, so the script exits non-zero):

1. Setup: CUDA must be available; TF32 is switched off; the card's name and
   power limit are read from ``nvidia-smi``; the four kernels (INT4,
   TERNARY and INT8 frontier scorers, row gather) are built from
   ``duckdb_lm_diskann_tpu_torch/csrc`` with one nvcc each, all started
   together (into the package's ``_build/``).
2. Each kernel against its plain PyTorch version at its main path's shapes,
   over 1,048,576 rows, B = 1024 random rows with repeats: INT4 at D = 128
   and 100 and INT8 at D = 128 and 100 (R = 64), for L2/IP/cosine,
   rtol = atol = 1e-5 (the two sum in a different f32 order); TERNARY at
   W = 30 (D = 960) and W = 4, exactly equal (integer scores); the row
   gather, exactly equal, at B = 1, 7, 1024 and 5000 with repeated and
   out-of-range rows, n_flight 4, 8 and 16: one 1280-word table and the
   four SoA tables (128, 64, 64, 1024 words) in its 16-byte path, a
   ragged 130-word table and a view one word off 16 bytes in its 4-byte
   path, and rows above 2^21 of a 1280-word table in both. Each is timed with CUDA
   events, every call on a fresh set of rows, two ways: each call alone
   behind a sleep kernel (``ms``) and a train of calls back to back behind
   one (``train_ms``, what a loop of launches pays a call); beside them the
   least time the card could take for the same work (``bound_ms``) and,
   for the one-table gather, ``torch.index_select`` (``library_ms``,
   ``library_train_ms``; the two are timed in turns: kernel, library,
   library, kernel, at B = 1024 and over B = 256, 1024, 4096 and 16,384,
   with the gather's launch plan). The three ring kernels (INT4, TERNARY, INT8) are also
   timed at B = 1, 256, 1024 and 2048 with their launch plans (grid,
   stages, branch), and held against their plain versions over 2^20 rows
   at B = 1, 7, 1024, 5000 and R = 5, 13, 64 (TERNARY at W = 2, 4, 30, 66;
   INT4 and INT8 at D = 30, 40, 100, 128, INT8 over every byte value),
   with zero scales, a zero query, repeated and out-of-range rows and
   misaligned table views: both the bulk-copy and the vector branch must
   run. The time of an empty kernel by both methods
   (``timing_floor_ms``, ``timing_floor_train_ms``) is printed beside them.
3. The hop profilers at 2^20 rows: ``experiments/profile_hop.py``'s
   knockout rows of a copy of the INT4 hop, then its row-gather A/B; then
   on one shared set of random tables ``experiments/profile_searcher.py``
   (knockouts of a mirror of the real hop, with and without the
   neighbor-validity gather) and ``experiments/profile_real.py`` (the real
   ``beam_search`` at visit caps 48 and 160: per-hop slope and fixed
   intercept, wall; its card column, from a torch.profiler trace, is the
   run's last card work, on fresh tables of the same seed, followed by
   its wall times once more). Last, ``experiments/ab_int4_layout.py``:
   five formulations of the INT4 edge score (interleaved bytes, planar
   words, two dot forms, the INT4 kernel) over 2^19 rows, B = 1024, held
   against ``decode_int4_np``'s distances, then each one's slope; its
   tables are freed before phase 4. Their rows go to standard output,
   each prefixed with its script's name. The row-gather kernel must launch
   in the A/B, the INT4 kernel in every other step, and ``profile_real``'s
   hops must equal both caps.
4. The main paths through ``Coordinator`` (on the card by default):
   ``bulk_build``, then (after one untimed warm-up batch) ``search`` in
   pipelined batches, then 20 B=1 queries:
   - INT4 headline: ``make_corpus(N, 128)``, L2, R=64, L_insert=128,
     alpha=1.2, INT4 edges, build batches of 2048; top-10 at L_search=100,
     search batches of 1024 (``--n``, default 500,000); then on the same
     graph the serving options: ``stream=True, lanes=1024`` (rowids
     identical to the lock-step batches), ``beam_width=2``, and a filter to
     a seeded 10% of the rows (every result inside it, recall against a
     brute-force scan of the subset); then ``experiments/ab_stream.py``
     (lock-step batches of 1024 against the stream at 512, 1024 and 2048
     lanes, ids held equal at 1024 lanes), before the lifecycle;
   - HARD: ``make_hard_corpus(N, 128, seed=0x4A2D)``, L2, INT4, R=64,
     L_insert=128, build batches of 1024; 2048 queries, top-10 at
     L_search=100, streamed over 512 lanes with and without adaptive seeds
     (2 of a 4096-node sample), each identical to the lock-step batches of
     512 with the same options (``--hard-n``, default 100,000); then
     ``experiments/ab_hard_recall.py``'s baseline and seven of its twelve
     configurations (``HARD_GRID``: adaptive seeds, L, beam width 2)
     against the exact top-k, one timed call each after the first,
     printed only;
   - GIST: ``make_corpus(N, 960, seed=0x61577)``, cosine, default codec
     (TERNARY), R=64, L_insert=128, build batches of 1024; 1024 queries,
     top-10 at L_search=128, search batches of 256 (``--gist-n``, default
     131,072: the ``parallel`` phase and the instruments took the room);
   - INT8: ``make_corpus(N, 128)``, L2, default codec (INT8), R=64,
     L_insert=128, build batches of 2048; top-10 at L_search=100, search
     batches of 1024 (``--int8-n``, default 131,072).
   The index lifecycle rides on two of them: HARD runs ``refine()`` (the
   build-side Vamana second pass and its reachability repair) right after
   its build, as ``bench.py`` does, with one lock-step search before it;
   the headline, after its serving searches, deletes two batches of 1,000
   rows picked from the path's rng (cold, then steady with its phases
   timed by ``experiments/profile_delete.py``), searches the live rows (no
   deleted row may come back; recall@10 against a scan of the live rows),
   vacuums (2,000 slots recycled; every live node reachable,
   ``utils/verify.py``), re-inserts the 2,000 rows (each into a recycled
   slot) and searches again against the whole corpus. Then persistence
   and the SQL surface on that index (``store_db_headline``): a full
   ``save_index`` into ``<tmp>/db.lmd_idx/headline`` (seconds, bytes of
   graph.lmd, GB/s; ``<tmp>`` must hold twice the checkpoint); a Database
   ``connect(<tmp>/db)`` whose ``create_index`` over a table of the corpus
   reopens the checkpoint with no build and no launch, into tables, maps
   and entry equal to the saved index's (as a checkpoint gives them back)
   and answering the queries with the pre-save ids and distances; 16
   single ``knn`` queries (index scan plan, ids == the Coordinator's, B=1
   ms), ``knn_join`` over the queries (QPS, recall@10), 16 brute-force
   ``knn`` scans of a table with no index (== the exact top-k), the index
   pragma; 1,000 rows deleted through the table and an incremental
   ``checkpoint`` that writes exactly the dirtied blocks; the CLI's
   ``bench`` in a subprocess on that checkpoint (recall@10 >= 0.95 against
   the live rows, no deleted row); every ``tests/sql`` file replayed on
   the card. Every block file must be the native store. Then the sharded
   engines on the headline (``parallel_headline``): the index in four row
   blocks on the card (``GlobalShardedIndex``), whose search at the
   headline's batches must equal the Coordinator's (ids, distances,
   hops) with the INT4 kernel launched once a block; the persistence
   phase's checkpoint loaded into row blocks (``load_global_sharded``),
   answering with the CLI's ids; a disjoint ``ShardedIndex`` of 4 x 65,536
   of the corpus' rows (its answer == the merge of its shards' own
   searches, recall@10 >= 0.95, exact distances, ``save`` ->
   ``load_sharded`` -> the same answer); ``distributed_build`` of the
   first 32,768 rows, then 1,000
   rows deleted and a vacuum, every table and the entry equal to a
   Coordinator's after the same steps; and ``torch.cuda.device_count()``
   processes (this script with ``--multihost-worker``, NCCL) of two
   shards each over the first 65,536 rows, whose answer must equal one
   process's ``ShardedIndex`` over the same shards; then, in the same
   processes, one global graph of the first 16,384 rows in two row blocks
   a process (``make_global_mesh``, rows reassembled by NCCL
   ``all_reduce``), whose search, ``distributed_build``, delete and
   shard-parallel save -> ``load_global_sharded`` must equal each
   process's own Coordinator. The last step of the headline, HARD and
   GIST is ``experiments/profile_insert.py`` (it inserts new rows, so it
   follows every check that reads the index): two steady insert batches
   of the path's build batch size, then the insert path's candidate
   search alone at beam widths 1 and 2 on a third batch; the path's
   kernel must launch.
5. The codecs without a TPU kernel: DEEP's corpus (``make_corpus(N, 96,
   seed=0xDEE9)``), cosine, R=64, L_insert=128, L_search=100, 4096
   queries, built and searched with FLOAT32, FLOAT16, NONE and FLOAT1BIT
   (``--codec-n``, default 32,768); no kernel may launch; recall@10 must
   reach 0.95 (FLOAT1BIT's, sign-only navigation, is printed).
6. INT8 node vectors: the headline's corpus scaled and rounded into
   [-128, 127] (``--int8-nodes-n``, default 32,768), built with INT8 and
   with FLOAT32 node vectors, for L2/INT8 and cosine/TERNARY edges: the
   rowids of the two builds must be identical and the INT8 vector table a
   quarter of the bytes.

In phases 4-6 every kernel counter is set to 0 just before a path (and
before each serving search and lifecycle phase) and read just after; the
path's kernel must have launched in its build and in each search, and no
other kernel. recall@10 against a brute-force scan on the card must reach
0.95 where stated (HARD's is printed, not held), and every returned
distance must equal the exact f64 one to 1e-4. Each search reports QPS,
hops, visits per query and the hop roofline's ``sol_qps`` and
``sol_fraction``. Each path's tensors are freed before the next.

``--ab-only`` runs instead the four A/B scripts of ``experiments/`` that
build their own indexes, each at its default size: ``ab_insert_width``
(100,000 rows: insert width x serving width), ``ab_width_iso`` (200,000
rows: W x L, then INT8 node vectors), ``ab_hard_build`` (HARD 100,000:
five build configurations, adaptive seeds at L = 100, 150, 200) and
``paper_scale_gist1m`` (``--gist-scale-n`` rows of its 960-d corpus, 8 row
blocks on the card, build batches of 1024; then the full 2^20-row GIST1M
graph allocated as 8 blocks). The counters are set to 0 before every
build and search; INT4 (TERNARY for the last) must launch in each, and no
other kernel. Every returned distance must equal the exact f64 one to
1e-4 (the INT8-node arm's against the rounded vectors it holds); recall@10
must reach 0.95 on every FLOAT32-node search of the first two, 0.93 on
``paper_scale_gist1m``, whose blocks must each hold total / 8; HARD's and
the INT8 arm's recall is printed. It prints a line ``{"ab": {...}}``, the
card's name and power limit and the ``ok`` line.

Standard output: the profilers' and instruments' rows, a line of
end-to-end numbers per path, a line ``{"instruments": {...}}`` with every
instrument's numbers, the card's name and power limit, a line with the
kernels' numbers, and last ``{"ok": true, "device": {...}}``. Progress
goes to standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

# The H100 SXM's published peaks: HBM bytes/s and scalar float32 op/s (the
# kernels' integer work is counted against the same scalar rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
_PKG = "duckdb_lm_diskann_tpu_torch"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, n_calls: int, wall: bool = False) -> float:
    """Median over ``n_calls`` calls of the card's time per call, after a
    warm-up; fn(i) gets the call index. The calls are issued behind a sleep
    kernel (``utils.cuda_timing.device_ms``), so the CUDA events around
    each call time the card's work, not the host's launch path. ``wall``:
    issued to an idle card instead, host launch path included."""
    from duckdb_lm_diskann_tpu_torch.utils import cuda_timing

    for i in range(3):
        fn(i)
    timer = cuda_timing.wall_ms if wall else cuda_timing.device_ms
    return float(np.median(timer(lambda i: fn(3 + i), n_calls)))


def train_ms(torch, fn, n_calls: int) -> float:
    """The card's time per call of a train of ``n_calls`` calls issued back
    to back behind one sleep kernel (``utils.cuda_timing.device_ms_train``),
    after a warm-up; fn(i) gets the call index, so the train reads the same
    fresh rows as ``time_ms``. Each call is charged what a loop of launches
    pays for it, without the events' cost around a lone call."""
    from duckdb_lm_diskann_tpu_torch.utils import cuda_timing

    for i in range(3):
        fn(i)
    return cuda_timing.device_ms_train(lambda i: fn(3 + i), n_calls)


def bound(curs, reps, row_bytes, fixed_bytes, ops):
    """Least time (ms) of the timed calls, median over them: the distinct
    rows each call gathers (``row_bytes`` each) plus the bytes every call
    moves once (queries, cur, output), over the HBM rate, or the operations
    over the scalar rate, whichever is larger."""
    times, by = [], "bytes"
    for i in range(3, 3 + reps):
        rows = int(curs[i].unique().numel())
        t_bytes = (rows * row_bytes + fixed_bytes) / PEAK_BYTES_PER_S
        t_ops = ops / PEAK_SCALAR_OPS_PER_S
        times.append(1e3 * max(t_bytes, t_ops))
        by = "bytes" if t_bytes >= t_ops else "operations"
    return float(np.median(times)), by


# Batch sizes of the scorers' time sweep: B=1 latency, GIST search (256),
# GIST and INT8 build (1024), the INT4 headline build (2048).
SWEEP_BATCHES = (1, 256, 1024, 2048)


def plan_of(plan):
    return {"grid": plan.grid, "stages": plan.stages,
            "branch": "bulk" if plan.bulk else "vector"}


def batch_sweep(torch, dev, gen, mod, name, n_rows, reps, make_queries, call,
                row_bytes, fixed_bytes_per_query, ops_per_query):
    """Card time of a ring scorer at each of SWEEP_BATCHES on fresh rows of
    ``n_rows`` (lone calls and a train), beside its bound and the plan it
    launched with."""
    out = {}
    for b in SWEEP_BATCHES:
        queries = make_queries(b)
        curs = _random_curs(torch, dev, gen, n_rows, b, reps)
        ms = time_ms(torch, lambda i: call(curs[i], queries), reps)
        train = train_ms(torch, lambda i: call(curs[i], queries), reps)
        bound_ms, _ = bound(curs, reps, row_bytes, b * fixed_bytes_per_query,
                            b * ops_per_query)
        out[str(b)] = {"ms": ms, "train_ms": train, "bound_ms": bound_ms,
                       "plan": plan_of(mod.LAST_PLAN)}
        log(f"{name} B={b}: kernel {ms:.5f} ms (train {train:.5f}), bound "
            f"{bound_ms:.5f} ms, plan {out[str(b)]['plan']}")
    return out


# Batch sizes of the row gather's sweep against index_select: the smaller
# ones weigh the gap between kernels, the larger the steady rate.
GATHER_BATCHES = (256, 1024, 4096, 16384)


def gather_sweep(torch, dev, gen, kg, src, n_rows, reps):
    """The row gather (K = 8) and ``index_select`` on fresh rows of ``src``
    at each of GATHER_BATCHES, in turns (kernel, library, library, kernel),
    by lone calls and in trains, beside the bound and the kernel's plan."""
    out = {}
    x = src.shape[1]
    for b in GATHER_BATCHES:
        curs = _random_curs(torch, dev, gen, n_rows, b, reps)

        def kern(i):
            return kg.pipelined_gather(curs[i], src, 8)

        def lib(i):
            return torch.index_select(src, 0, curs[i])

        fns = (kern, lib, lib, kern)
        lone = [time_ms(torch, fn, reps) for fn in fns]
        train = [train_ms(torch, fn, reps) for fn in fns]
        bound_ms, _ = bound(curs, reps, 4 * x, b * (4 * x + 4), 0)
        rec = {
            "ms": (lone[0] + lone[3]) / 2,
            "library_ms": (lone[1] + lone[2]) / 2,
            "train_ms": (train[0] + train[3]) / 2,
            "library_train_ms": (train[1] + train[2]) / 2,
            "turns_ms": lone, "train_turns_ms": train, "bound_ms": bound_ms,
            "plan": kg.LAST_PLAN._asdict(),
        }
        out[str(b)] = rec
        log(f"row gather B={b}: kernel {rec['ms']:.5f} ms (train "
            f"{rec['train_ms']:.5f}), index_select {rec['library_ms']:.5f} "
            f"(train {rec['library_train_ms']:.5f}), bound {bound_ms:.5f} "
            f"ms, plan {rec['plan']}")
        del curs
    return out


def _random_curs(torch, dev, gen, n_rows, b, reps):
    curs = torch.randint(
        0, n_rows, (reps + 3, b), dtype=torch.int32, device=dev, generator=gen,
    )
    curs[:, 1::7] = curs[:, :1]  # repeated rows
    return curs


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def check_float_scorer(torch, dev, codec, n_rows=1 << 20, r=64, b=1024,
                       reps=20):
    """INT4 or INT8 kernel vs plain at its path's shapes (D = 128, and 100
    for a ragged row), for L2/IP/cosine. Returns the kernel's record."""
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.kernels import int8_frontier as k8

    mod, fn_name, seed, replaces = {
        "int4": (k4, "int4_frontier_scores", 0x1A4, ("335", "433")),
        "int8": (k8, "int8_frontier_scores", 0x18, ("478",)),
    }[codec]
    kernel = getattr(mod, fn_name)
    plain = getattr(mod, fn_name + "_plain")
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err = 0.0
    rec = {}
    for d in (128, 100):
        if codec == "int4":  # random planar words: every nibble value
            width = (d + 7) // 8
            codes = torch.randint(
                -(2**31), 2**31, (n_rows, r, width), dtype=torch.int32,
                device=dev, generator=gen,
            )
            row_bytes, scale_max = r * (4 * width + 4), 0.05
        else:
            codes = torch.randint(
                -128, 128, (n_rows, r, d), dtype=torch.int8, device=dev,
                generator=gen,
            )
            codes[:, ::8] = 0
            row_bytes, scale_max = r * (d + 4), 0.005
        scale = scale_max * torch.rand((n_rows, r), device=dev, generator=gen)
        scale[:, ::8] = 0.0  # empty edge slots
        queries = 0.3 * torch.randn((b, d), device=dev, generator=gen)
        curs = _random_curs(torch, dev, gen, n_rows, b, reps)
        for metric in (MetricType.L2, MetricType.IP, MetricType.COSINE):
            got = kernel(curs[0], queries, codes, scale, metric=metric)
            want = plain(curs[0], queries, codes, scale, metric=metric)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(
                    f"{codec} output not finite (D={d}, {metric})"
                )
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"{codec} == plain: D={d} {metric.value} max_abs_err={err:.3g}")
        if d == 128:
            for name, fn in (("ms", kernel), ("plain_ms", plain)):
                rec[name] = time_ms(
                    torch,
                    lambda i, fn=fn: fn(
                        curs[i], queries, codes, scale, metric=MetricType.L2
                    ),
                    reps,
                )
            def l2(i):
                return kernel(curs[i], queries, codes, scale,
                              metric=MetricType.L2)

            rec["train_ms"] = train_ms(torch, l2, reps)
            rec["wall_ms"] = time_ms(torch, l2, reps, wall=True)
            rec["bound_ms"], rec["bound_by"] = bound(
                curs, reps, row_bytes=row_bytes,
                fixed_bytes=b * (4 * d + 4 + 4 * r), ops=4 * b * r * d,
            )
            rec["plan"] = plan_of(mod.LAST_PLAN)
            log(f"{codec} B={b} R={r} D={d} L2: kernel {rec['ms']:.5f} ms "
                f"(train {rec['train_ms']:.5f}, wall {rec['wall_ms']:.4f}), "
                f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} "
                f"ms, plan {rec['plan']}")
            rec["by_batch"] = batch_sweep(
                torch, dev, gen, mod, f"{codec} D=128 L2", n_rows, reps,
                lambda nb: 0.3 * torch.randn((nb, d), device=dev,
                                             generator=gen),
                lambda cur, q: kernel(cur, q, codes, scale,
                                      metric=MetricType.L2),
                row_bytes, 4 * d + 4 + 4 * r, 4 * r * d,
            )
        del codes, scale, queries, curs
        _free(torch)
    pallas = "duckdb_lm_diskann_tpu/experiments/pallas_kernels.py"
    return {
        "name": fn_name,
        "route": "cuda",
        "source": f"{_PKG}/csrc/{codec}_frontier.cu",
        "replaces": f"{pallas}:{replaces[0]}",
        **({"also_replaces": f"{pallas}:{replaces[1]}"} if len(replaces) > 1
           else {}),
        "max_abs_err": max_err,
        **rec,
        "library_ms": None,
    }


def check_ternary(torch, dev, n_rows=1 << 20, r=64, b=1024, reps=20):
    """TERNARY kernel vs plain at the GIST shapes (W = 30) and at W = 4:
    exactly equal. Returns its record."""
    from duckdb_lm_diskann_tpu_torch.kernels import ternary_frontier as kt

    gen = torch.Generator(device=dev).manual_seed(0x7E2)
    rec = {}
    for w in (30, 4):
        planes = [
            torch.randint(
                -(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                generator=gen,
            )
            for shape in ((n_rows, r, w), (n_rows, r, w), (b, w), (b, w))
        ]
        ep, en, qp, qn = planes
        # A ternary value is never both signs: clear the shared bits, and
        # leave every 8th edge slot empty.
        en &= ~ep
        qn &= ~qp
        ep[:, ::8] = 0
        en[:, ::8] = 0
        curs = _random_curs(torch, dev, gen, n_rows, b, reps)
        got = kt.ternary_frontier_scores(curs[0], qp, qn, ep, en)
        want = kt.ternary_frontier_scores_plain(curs[0], qp, qn, ep, en)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ternary kernel != plain at W={w}: {bad} scores")
        log(f"ternary == plain: W={w} exactly ({b}x{r} scores)")
        if w == 30:
            for name, fn in (
                ("ms", kt.ternary_frontier_scores),
                ("plain_ms", kt.ternary_frontier_scores_plain),
            ):
                rec[name] = time_ms(
                    torch, lambda i, fn=fn: fn(curs[i], qp, qn, ep, en), reps
                )
            def scores(i):
                return kt.ternary_frontier_scores(curs[i], qp, qn, ep, en)

            rec["train_ms"] = train_ms(torch, scores, reps)
            rec["wall_ms"] = time_ms(torch, scores, reps, wall=True)
            rec["bound_ms"], rec["bound_by"] = bound(
                curs, reps, row_bytes=r * w * 4 * 2,
                fixed_bytes=b * (4 * 2 * w + 4 + 4 * r), ops=12 * b * r * w,
            )
            log(f"ternary B={b} R={r} W={w}: kernel {rec['ms']:.5f} ms "
                f"(train {rec['train_ms']:.5f}, wall {rec['wall_ms']:.4f}), "
                f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")
            rec["plan"] = plan_of(kt.LAST_PLAN)

            def query_planes(nb):
                p = torch.randint(-(2**31), 2**31, (nb, w), dtype=torch.int32,
                                  device=dev, generator=gen)
                n = torch.randint(-(2**31), 2**31, (nb, w), dtype=torch.int32,
                                  device=dev, generator=gen)
                return p, n & ~p

            rec["by_batch"] = batch_sweep(
                torch, dev, gen, kt, f"ternary W={w}", n_rows, reps,
                query_planes,
                lambda cur, q: kt.ternary_frontier_scores(cur, *q, ep, en),
                r * w * 4 * 2, 4 * 2 * w + 4 + 4 * r, 12 * r * w,
            )
        del planes, ep, en, qp, qn, curs
        _free(torch)
    return {
        "name": "ternary_frontier_scores",
        "route": "cuda",
        "source": f"{_PKG}/csrc/ternary_frontier.cu",
        "replaces": "duckdb_lm_diskann_tpu/experiments/pallas_kernels.py:124",
        "also_replaces": "duckdb_lm_diskann_tpu/experiments/pallas_kernels.py:223",
        "max_abs_err": 0.0,
        **rec,
        "library_ms": None,
    }


RING_BATCHES = (1, 7, 1024, 5000)  # 5000: many wraps of every ring
RING_ROWS = (5, 13, 64)  # R = 5 and 13 take the vector branch


def check_ring_cases(torch, dev, n_rows=1 << 20):
    """The three ring kernels against their plain versions over 2^20 rows
    at every B of RING_BATCHES and R of RING_ROWS: TERNARY at W = 2, 4, 30,
    66 exactly, INT4 and INT8 at D = 30, 40, 100, 128 for L2/IP/cosine to
    rtol = atol = 1e-5 (``float_ring_cases``); rows repeat and two lie out
    of range (the plain version gets them clamped: it indexes); a view of
    each table off a 16-byte boundary takes the vector branch. Both
    branches must run. Returns {"ternary": ..., "int4": ..., "int8": ...}
    with the cases, largest error and branches."""
    from duckdb_lm_diskann_tpu_torch.kernels import ternary_frontier as kt

    gen = torch.Generator(device=dev).manual_seed(0x121A6)

    def words(n):  # every bit pattern: the kernels are exact for any bits
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                             device=dev, generator=gen)

    def curs(b):
        cur = torch.randint(0, n_rows, (b,), dtype=torch.int32, device=dev,
                            generator=gen)
        cur[1::7] = cur[0]
        if b > 3:
            cur[2], cur[3] = -5, n_rows + 9
        return cur, cur.clamp(0, n_rows - 1)

    def view(flat, shape, off=0):
        n = int(np.prod(shape))
        return flat[off : off + n].view(shape)

    out = {}
    t0 = time.perf_counter()
    flat_p, flat_n = words(n_rows * 64 * 66 + 1), words(n_rows * 64 * 66 + 1)
    plans, cases = set(), 0
    for r in RING_ROWS:
        for w in (2, 4, 30, 66):
            ep, en = (view(f, (n_rows, r, w)) for f in (flat_p, flat_n))
            for b in RING_BATCHES:
                qp, qn = words(b * w).view(b, w), words(b * w).view(b, w)
                cur, clamped = curs(b)
                got = kt.ternary_frontier_scores(cur, qp, qn, ep, en)
                plans.add(tuple(plan_of(kt.LAST_PLAN).values()))
                want = kt.ternary_frontier_scores_plain(clamped, qp, qn, ep, en)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"ternary ring != plain: R={r} W={w} B={b}, "
                        f"{int((got != want).sum())} scores, {kt.LAST_PLAN}")
                cases += 1
    ep, en = (view(f, (n_rows, 5, 30), off=1) for f in (flat_p, flat_n))
    q = words(1025 * 30).view(1025, 30)
    cur, clamped = curs(1024)
    got = kt.ternary_frontier_scores(cur, q[1:], q[1:], ep, en)
    plans.add(tuple(plan_of(kt.LAST_PLAN).values()))
    if not torch.equal(got, kt.ternary_frontier_scores_plain(
            clamped, q[1:], q[1:], ep, en)):
        raise AssertionError("ternary ring != plain on misaligned views")
    branches = sorted({p[2] for p in plans})
    if branches != ["bulk", "vector"]:
        raise AssertionError(f"ternary ring cases ran branches {branches}")
    out["ternary"] = {"cases": cases + 1, "max_abs_err": 0.0,
                      "branches": branches}
    log(f"ternary ring == plain: {cases + 1} cases, branches {branches}, "
        f"{time.perf_counter() - t0:.1f} s")
    del flat_p, flat_n, ep, en, q
    _free(torch)

    for codec in ("int4", "int8"):
        out[codec] = float_ring_cases(torch, dev, gen, codec, n_rows, curs, view)
    return out


def float_ring_cases(torch, dev, gen, codec, n_rows, curs, view):
    """INT4 (D = 30, 40, 100, 128 in random planar words: every nibble) or
    INT8 (the same D, every byte value, -128 included) over every R of
    RING_ROWS and B of RING_BATCHES, for L2/IP/cosine, to rtol = atol =
    1e-5: a quarter of the scales are 0 (empty slots), query 0 is zero
    (cosine 1.0), rows repeat and two lie out of range; then a view of each
    table off its 16-byte boundary (INT8: a byte off) takes the vector
    branch; INT8 also at R=128, D=3072 and R=13, D=12288, nodes too large
    for two stages, scored in pieces. Both branches must run. Returns the
    codec's cases, largest error and branches."""
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.kernels import int8_frontier as k8

    t0 = time.perf_counter()
    if codec == "int4":
        mod, score, plain = (k4, k4.int4_frontier_scores,
                             k4.int4_frontier_scores_plain)
        flat_c = torch.randint(-(2**31), 2**31, (n_rows * 64 * 16 + 1,),
                               dtype=torch.int32, device=dev, generator=gen)

        def codes_of(r, d, off=0):
            return view(flat_c, (n_rows, r, (d + 7) // 8), off)
    else:
        mod, score, plain = (k8, k8.int8_frontier_scores,
                             k8.int8_frontier_scores_plain)
        flat_c = torch.randint(-128, 128, (n_rows * 64 * 128 + 1,),
                               dtype=torch.int8, device=dev, generator=gen)

        def codes_of(r, d, off=0):
            return view(flat_c, (n_rows, r, d), off)
    flat_s = 0.05 * torch.rand(n_rows * 64 + 1, device=dev, generator=gen)
    if codec == "int8":
        flat_s *= 0.1  # codes up to 128, not 8
    flat_s[::4] = 0.0  # empty edge slots
    plans, cases, max_err = set(), 0, 0.0

    def hold(cur, clamped, q, codes, scale, what):
        nonlocal cases, max_err
        for metric in (MetricType.L2, MetricType.IP, MetricType.COSINE):
            got = score(cur, q, codes, scale, metric=metric)
            plans.add(tuple(plan_of(mod.LAST_PLAN).values()))
            want = plain(clamped, q, codes, scale, metric=metric)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{codec} ring output not finite: {what}")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{codec} ring {what}: {m}")
            max_err = max(max_err, float((got - want).abs().max()))
            cases += 1

    for r in RING_ROWS:
        for d in (30, 40, 100, 128):
            codes, scale = codes_of(r, d), view(flat_s, (n_rows, r))
            for b in RING_BATCHES:
                q = 0.3 * torch.randn((b, d), device=dev, generator=gen)
                q[0] = 0.0  # zero query: cosine 1.0
                hold(*curs(b), q, codes, scale, f"R={r} D={d} B={b}")
    q = 0.3 * torch.randn((1025, 30), device=dev, generator=gen)
    hold(*curs(1024), q[1:], codes_of(5, 30, off=1),
         view(flat_s, (n_rows, 5), off=1), "misaligned views")
    if codec == "int8":  # nodes scored in pieces of stage_rows(R, D) rows
        for r, d in ((128, 3072), (13, 12288)):
            n = min(n_rows, 4096)
            codes = torch.randint(-128, 128, (n, r, d), dtype=torch.int8,
                                  device=dev, generator=gen)
            scale = 0.002 * torch.rand((n, r), device=dev, generator=gen)
            scale[:, ::4] = 0.0
            for b in RING_BATCHES[1:3]:  # 7, 1024
                q = 0.3 * torch.randn((b, d), device=dev, generator=gen)
                cur = torch.randint(-2, n + 2, (b,), dtype=torch.int32,
                                    device=dev, generator=gen)
                hold(cur, cur.clamp(0, n - 1), q, codes, scale,
                     f"R={r} D={d} B={b} in pieces of "
                     f"{k8.stage_rows(r, d)} rows")
    branches = sorted({p[2] for p in plans})
    if branches != ["bulk", "vector"]:
        raise AssertionError(f"{codec} ring cases ran branches {branches}")
    log(f"{codec} ring == plain: {cases} cases (x metric), max_abs_err "
        f"{max_err:.3g}, branches {branches}, "
        f"{time.perf_counter() - t0:.1f} s")
    del flat_c, flat_s, codes, scale, q
    _free(torch)
    return {"cases": cases, "max_abs_err": max_err, "branches": branches}


def reset_counts(kernels):
    for mod in kernels.values():
        mod.LAUNCHES = 0
        if hasattr(mod, "LAUNCHES4"):
            mod.LAUNCHES4 = 0


def check_row_gather(torch, dev, n_rows=1 << 20, b=1024, reps=20,
                     hi_rows=1 << 21):
    """Row-gather kernel vs plain, exactly: one 1280-word table and the
    four SoA tables at n_flight 4, 8 and 16 (16-byte path), a ragged
    130-word table and a table view one word off 16 bytes (4-byte path), and
    rows above 2^21 of a 1280-word table in both paths. Then its times: in
    turns with index_select at B = 1024 and over GATHER_BATCHES, by K, and
    the four tables'. Returns the records of its two entry points
    (pipelined_gather, pipelined_gather4)."""
    from duckdb_lm_diskann_tpu_torch.kernels import row_gather as kg

    gen = torch.Generator(device=dev).manual_seed(0x6A7)

    def rand(shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    paths = set()

    def same(got, want, what):
        torch.cuda.synchronize()
        paths.add("16-byte" if all(kg.LAST_PLAN.vec) else "4-byte")
        if not torch.equal(got, want):
            bad = int((got != want).any(-1).sum())
            raise AssertionError(f"row gather != plain: {what}, {bad} rows")

    curs = _random_curs(torch, dev, gen, n_rows, b, reps)
    sep4 = [rand((n_rows, x)) for x in (128, 64, 64, 1024)]
    combined = torch.cat(sep4, 1)
    x = combined.shape[1]
    ragged = rand((n_rows, 130))  # 4-byte path: 520-byte rows
    flat = combined.view(-1)  # 4-byte path: a view one word off 16 bytes
    shifted = flat[1 : 1 + (n_rows - 1) * x].view(n_rows - 1, x)
    cases = 0
    for nb in (1, 7, 1024, 5000):
        idx = torch.randint(0, n_rows, (nb,), dtype=torch.int32, device=dev,
                            generator=gen)
        idx[1::7] = idx[0]  # repeated rows
        idx[2:3] = -5  # out of range: clamped to row 0
        idx[3:4] = 10**7  # out of range: clamped to the last row
        for k in (4, 8, 16):
            for name, t in (("X=1280", combined), ("X=130", ragged),
                            ("X=1280 one word off", shifted)):
                same(kg.pipelined_gather(idx, t, n_flight=k),
                     kg.pipelined_gather_plain(idx, t), f"{name} B={nb} K={k}")
            for got, t in zip(kg.pipelined_gather4(idx, sep4, n_flight=k),
                              sep4):
                same(got, kg.pipelined_gather_plain(idx, t),
                     f"four tables, X={t.shape[1]} B={nb} K={k}")
            cases += 4
    del ragged, flat, shifted
    if paths != {"16-byte", "4-byte"}:
        raise AssertionError(f"row gather cases ran paths {paths}")
    log(f"row gather == plain: {cases} cases (B=1/7/1024/5000 x K=4/8/16 x "
        "X=1280, X=130, a view one word off, the four SoA tables), both "
        "paths")
    one, four = {}, {}
    row_bytes, fixed = 4 * x, b * (4 * x + 4)  # distinct rows read; out + idx
    one["bound_ms"], one["bound_by"] = bound(curs, reps, row_bytes, fixed, 0)
    four["bound_ms"], four["bound_by"] = one["bound_ms"], one["bound_by"]
    by_k, train_by_k = {}, {}
    for k in (4, 8, 16):
        def call(i, k=k):
            return kg.pipelined_gather(curs[i], combined, k)

        by_k[str(k)] = time_ms(torch, call, reps)
        train_by_k[str(k)] = train_ms(torch, call, reps)
    one["ms_by_n_flight"] = by_k
    one["train_ms_by_n_flight"] = train_by_k
    # Kernel and index_select in turns (kernel, library, library, kernel):
    # each number is the mean of its two turns.
    def kern(i):
        return kg.pipelined_gather(curs[i], combined, 8)

    def lib(i):
        return torch.index_select(combined, 0, curs[i])

    turns = [time_ms(torch, fn, reps) for fn in (kern, lib, lib, kern)]
    one["turns_ms"] = {"kernel": [turns[0], turns[3]],
                       "index_select": [turns[1], turns[2]]}
    one["ms"] = (turns[0] + turns[3]) / 2
    one["library_ms"] = (turns[1] + turns[2]) / 2
    trains = [train_ms(torch, fn, reps) for fn in (kern, lib, lib, kern)]
    one["train_turns_ms"] = {"kernel": [trains[0], trains[3]],
                             "index_select": [trains[1], trains[2]]}
    one["train_ms"] = (trains[0] + trains[3]) / 2
    one["library_train_ms"] = (trains[1] + trains[2]) / 2
    one["wall_ms"] = time_ms(torch, kern, reps, wall=True)
    one["plan"] = kg.LAST_PLAN._asdict()
    one["by_batch"] = gather_sweep(torch, dev, gen, kg, combined, n_rows, reps)
    one["plain_ms"] = time_ms(
        torch, lambda i: kg.pipelined_gather_plain(curs[i], combined), reps
    )
    four["ms"] = time_ms(
        torch, lambda i: kg.pipelined_gather4(curs[i], sep4, 8), reps
    )
    four["train_ms"] = train_ms(
        torch, lambda i: kg.pipelined_gather4(curs[i], sep4, 8), reps
    )
    four["wall_ms"] = time_ms(
        torch, lambda i: kg.pipelined_gather4(curs[i], sep4, 8), reps,
        wall=True,
    )
    four["plan"] = kg.LAST_PLAN._asdict()
    four["plain_ms"] = time_ms(
        torch,
        lambda i: [kg.pipelined_gather_plain(curs[i], t) for t in sep4],
        reps,
    )
    four["library_ms"] = None  # no single PyTorch call gathers four tables
    log(f"row gather in turns (kernel, index_select, index_select, "
        f"kernel): {', '.join(f'{t:.5f}' for t in turns)} ms; trains "
        f"{', '.join(f'{t:.5f}' for t in trains)} ms")
    log(f"row gather B={b} X={x}: kernel {one['ms']:.5f} ms (train "
        f"{one['train_ms']:.5f}, wall {one['wall_ms']:.4f}; K=4/8/16 "
        f"{by_k['4']:.4f}/{by_k['8']:.4f}/{by_k['16']:.4f}, trains "
        f"{train_by_k['4']:.5f}/{train_by_k['8']:.5f}/"
        f"{train_by_k['16']:.5f}), plain {one['plain_ms']:.4f} ms, "
        f"index_select {one['library_ms']:.4f} ms, bound "
        f"{one['bound_ms']:.5f} ms, plan {one['plan']}; four tables: kernel "
        f"{four['ms']:.5f} ms (train {four['train_ms']:.5f}, wall "
        f"{four['wall_ms']:.4f}), plain {four['plain_ms']:.4f} ms, plan "
        f"{four['plan']}")
    del sep4, combined
    _free(torch)

    # Rows past 2^21 of a 1280-word table (row * X passes 2^31), in both
    # paths: only the gathered rows (and the next, for the shifted view)
    # are written.
    big = torch.empty((hi_rows + (1 << 12), 1280), dtype=torch.int32,
                      device=dev)
    hi = torch.randint(hi_rows, big.shape[0] - 1, (b,), dtype=torch.int32,
                       device=dev, generator=gen)
    hi[1::7] = hi[0]
    big[hi.long()] = rand((b, 1280))
    big[hi.long() + 1] = rand((b, 1280))
    big_shifted = big.view(-1)[1 : 1 + (big.shape[0] - 1) * 1280].view(-1, 1280)
    for k in (4, 8, 16):
        same(kg.pipelined_gather(hi, big, n_flight=k),
             kg.pipelined_gather_plain(hi, big), f"rows >= 2^21, K={k}")
        same(kg.pipelined_gather(hi, big_shifted, n_flight=k),
             kg.pipelined_gather_plain(hi, big_shifted),
             f"rows >= 2^21 one word off, K={k}")
    log("row gather == plain: rows >= 2^21 at X=1280, both paths")
    del big, big_shifted, hi, curs
    _free(torch)
    ref = "benchmarks/profile_hop.py"
    base = {"route": "cuda", "source": f"{_PKG}/csrc/row_gather.cu",
            "max_abs_err": 0.0}
    return (
        {"name": "pipelined_gather", **base, "replaces": f"{ref}:251", **one},
        {"name": "pipelined_gather4", **base, "replaces": f"{ref}:313", **four},
    )


def run_profiler(torch, dev, kernels):
    """The hop profilers at 2^20 rows, each run with the counters set to 0
    just before: ``profile_hop`` (knockout, then gather A/B), then
    ``profile_searcher`` (both valid modes) and ``profile_real`` on one
    shared set of tables. Returns their rows and the launches of the row
    gather and of the INT4 kernel."""
    from duckdb_lm_diskann_tpu_torch.experiments import (
        profile_hop,
        profile_real,
        profile_searcher,
    )

    def printer(tag):
        return lambda line: print(f"{tag} {line}", flush=True)

    k4 = kernels["int4"]
    int4 = {}

    def held(label):
        if k4.LAUNCHES <= 0:
            raise AssertionError(f"{label} never ran the INT4 kernel")
        int4[label] = check_launches(kernels, k4, label)

    t0 = time.perf_counter()
    reset_counts(kernels)
    knock = profile_hop.knockout(dev, out=printer("profile_hop"))
    held("profile_hop knockout")
    _free(torch)
    reset_counts(kernels)
    gather = profile_hop.gather_ab(dev, out=printer("profile_hop"))
    kg = kernels["row_gather"]
    launches = {"pipelined_gather": kg.LAUNCHES,
                "pipelined_gather4": kg.LAUNCHES4}
    if min(launches.values()) <= 0:
        raise AssertionError(f"profile_hop gather: row gather launches {launches}")
    _free(torch)
    t1 = time.perf_counter()
    tables = profile_real.make_tables(dev)
    searcher_rows = []
    for valid in (True, False):
        reset_counts(kernels)
        searcher_rows += profile_searcher.knockout(
            dev, tables, valid=valid, out=printer("profile_searcher"))
        held(f"profile_searcher valid={int(valid)}")
    reset_counts(kernels)
    # Wall times only: the card column comes last in the run
    # (run_profile_real_card), after every other wall time.
    real = profile_real.profile(dev, tables, card=False,
                                out=printer("profile_real"))
    held("profile_real")
    real.pop("results")
    caps, hops = (profile_real.V_LO, profile_real.V_HI), real["batch_hops"]
    timed = [i for i in range(len(hops[caps[0]]))
             if all(hops[v][i] == v for v in caps)]
    if not timed or len(timed) != real["batches_timed"]:
        raise AssertionError(f"profile_real: hops {hops} != the caps {caps}")
    del tables
    _free(torch)
    log(f"hop profilers took {time.perf_counter() - t0:.1f} s (searcher and "
        f"real {time.perf_counter() - t1:.1f} s); row gather launches "
        f"{launches}; INT4 launches {int4}")
    launches["int4"] = sum(int4.values())
    return ({"knockout": knock, "gather": gather},
            {"profile_searcher": searcher_rows, "profile_real": real,
             "int4_launches": int4}, launches)


def run_profile_real_card(torch, dev, kernels):
    """``profile_real``'s card column (its busy time in a torch.profiler
    trace) on fresh tables of the same seed, as the run's last card work:
    a profiler session may slow the launches that follow it in this
    process. Then its wall times once more, to show whether it did.
    Returns the card and after-profiler wall rows and the INT4 launches."""
    from duckdb_lm_diskann_tpu_torch.experiments import profile_real

    def printer(tag):
        return lambda line: print(f"profile_real {tag}{line}", flush=True)

    t0 = time.perf_counter()
    tables = profile_real.make_tables(dev)
    reset_counts(kernels)
    card = profile_real.card_profile(tables, out=printer(""))
    if card is None:
        log("profile_real: the profiler traced no device activity")
    after = profile_real.profile(dev, tables, card=False, reps=2,
                                 out=printer("after the profiler: "))["wall"]
    launches = check_launches(kernels, kernels["int4"], "profile_real card")
    del tables
    _free(torch)
    log(f"profile_real card column took {time.perf_counter() - t0:.1f} s")
    return {"card": card, "wall_after_profiler": after}, launches


def run_ab_int4_layout(torch, dev, kernels):
    """``experiments/ab_int4_layout.py`` as phase 3's last step: its tables
    (2^19 rows, B = 1024, R = 64, D = 128; ~4.5 GB) built on the card, the
    five rows held against ``decode_int4_np``'s distances, then each row's
    slope; the INT4 kernel (its ``kernel`` row) must launch, and no other.
    The tables are freed before phase 4."""
    from duckdb_lm_diskann_tpu_torch.experiments import ab_int4_layout

    def printer(line):
        print(f"ab_int4_layout {line}", flush=True)

    t0 = time.perf_counter()
    reset_counts(kernels)
    tables = ab_int4_layout.make_tables(dev)
    errs = ab_int4_layout.check(tables)
    for name, err in errs.items():
        printer(f"agree {name:7s}: max rel err {err:.3e}")
    times = ab_int4_layout.time_rows(tables, out=printer)
    launches = check_launches(kernels, kernels["int4"], "ab_int4_layout")
    del tables
    _free(torch)
    out = {"max_rel_err": errs, "times": times, "launches": launches,
           "s": time.perf_counter() - t0}
    log(f"ab_int4_layout took {out['s']:.1f} s, {launches} INT4 launches")
    return out


def exact_topk(torch, dev, data, queries, k, metric, chunk=1 << 17):
    """Brute-force top-k rowids on the card (``ab_hard_recall.exact_topk``:
    the port's all_pairs_distance in row chunks, then topk)."""
    from duckdb_lm_diskann_tpu_torch.experiments.ab_hard_recall import (
        exact_topk as brute_force,
    )

    return brute_force(data, queries, k, metric, dev, chunk=chunk)[0]


def exact_distances(queries, vecs, metric_name):
    """f64 distances of queries [B, D] to their results [B, k, D]."""
    q = queries[:, None, :].astype(np.float64)
    v = vecs.astype(np.float64)
    if metric_name == "l2":
        return np.sqrt(((q - v) ** 2).sum(-1))
    dot = (q * v).sum(-1)
    norm = np.linalg.norm(q, axis=-1) * np.linalg.norm(v, axis=-1)
    return 1.0 - np.clip(dot / np.where(norm > 0, norm, 1.0), -1.0, 1.0)


# The main paths: corpus, index options and serving options.
PATHS = {
    "int4_headline": dict(
        dims=128, seed=0xBE7C4, metric="l2", edge_type="int4", l_search=100,
        max_batch=2048, search_batch=1024, codec="int4", lifecycle=True,
        store_db=True, parallel=True, ab_stream=True, profile_insert=True,
    ),
    "hard": dict(
        dims=128, seed=0x4A2D, metric="l2", edge_type="int4", l_search=100,
        max_batch=1024, search_batch=512, codec="int4", corpus="hard",
        min_recall=None,  # 5% exact duplicates: strict recall is printed
        refine=True, ab_hard_recall=True, profile_insert=True,
    ),
    "gist_ternary": dict(
        dims=960, seed=0x61577, metric="cosine", edge_type=None,
        l_search=128, max_batch=1024, search_batch=256, codec="ternary",
        profile_insert=True,
    ),
    "int8_l2": dict(
        dims=128, seed=0xBE7C4, metric="l2", edge_type=None, l_search=100,
        max_batch=2048, search_batch=1024, codec="int8",
    ),
}


def recall_of(ids, truth, k):
    return float(np.mean([
        len(set(a) & set(b)) / k for a, b in zip(ids.tolist(), truth.tolist())
    ]))


def check_exact(name, data, queries, ids, dists, metric):
    """Every returned (rowid, distance) against the exact f64 distance;
    missing results (-1, +inf) are skipped. Returns the largest error."""
    ok = ids >= 0
    if not np.isfinite(dists[ok]).all() or np.isfinite(dists[~ok]).any():
        raise AssertionError(f"{name}: non-finite results or finite misses")
    exact = exact_distances(queries, data[np.maximum(ids, 0)], metric)
    err = float(np.abs(np.where(ok, dists - exact, 0.0)).max())
    if err > 1e-4:
        raise AssertionError(f"{name}: returned distances off by {err}")
    return err


def check_launches(kernels, kernel, label):
    """The launches of ``kernel`` since the counters were set to 0: it must
    have launched, and no other kernel. ``kernel`` None (a codec without a
    kernel): no kernel may have launched."""
    launches = 0 if kernel is None else kernel.LAUNCHES
    others = {c: m.LAUNCHES for c, m in kernels.items() if m is not kernel}
    if (kernel is not None and launches <= 0) or any(others.values()):
        raise AssertionError(
            f"{label}: kernel launches {launches}, other kernels {others}"
        )
    return launches


def timed_search(torch, kernels, kernel, coord, queries, k, label, **opts):
    """One Coordinator.search with the counters set to 0 just before; the
    path's kernel must launch and no other. Returns (ids, dists, metrics)
    with QPS, hops, visits per query and the hop roofline's numbers."""
    from duckdb_lm_diskann_tpu_torch.utils.roofline import (
        device_hbm_gbps,
        hop_roofline,
    )

    reset_counts(kernels)
    t0 = time.perf_counter()
    ids, dists = coord.search(queries, k, **opts)
    secs = time.perf_counter() - t0
    stats = coord.last_search_stats
    launches = check_launches(kernels, kernel, label)
    width = opts.get("beam_width", 1)
    batch = opts["lanes"] if opts.get("stream") else opts.get("batch_size")
    rl = hop_roofline(
        coord.params, batch=min(batch or len(queries), len(queries)),
        l_search=stats.l_search, beam_width=width,
        mean_visits=stats.mean_visits_per_query,
        hbm_gbps=device_hbm_gbps(torch.cuda.get_device_name(0)),
    )
    qps = len(queries) / secs
    m = {
        "search_s": secs, "qps": qps, "hops": stats.hops,
        "mean_visits_per_query": stats.mean_visits_per_query,
        "sol_qps": rl.sol_qps, "sol_fraction": qps / rl.sol_qps,
        "launches": launches,
    }
    log(f"{label}: {len(queries)} queries in {secs:.3f} s ({qps:.0f} QPS), "
        f"{stats.hops} hops, {m['mean_visits_per_query']:.2f} visits/query, "
        f"sol_qps {rl.sol_qps:.0f} (fraction {m['sol_fraction']:.4f}), "
        f"{launches} launches")
    return ids, dists, m


def serve_headline(torch, dev, kernels, kernel, coord, data, queries, ids,
                   truth, k, metric, batch):
    """The serving options on the headline graph: streaming lanes (rowids
    identical to the lock-step batches), E = 2, and a 10% filter."""
    out = {}
    ids_s, d_s, out["stream_1024"] = timed_search(
        torch, kernels, kernel, coord, queries, k, "headline stream",
        stream=True, lanes=1024,
    )
    if not np.array_equal(ids_s, ids):
        bad = int((ids_s != ids).any(-1).sum())
        raise AssertionError(f"stream rowids != lock-step on {bad} queries")
    out["stream_1024"]["max_dist_err"] = check_exact(
        "headline stream", data, queries, ids_s, d_s, metric)
    ids_w, d_w, out["beam_width_2"] = timed_search(
        torch, kernels, kernel, coord, queries, k, "headline E=2",
        beam_width=2, batch_size=batch,
    )
    out["beam_width_2"]["max_dist_err"] = check_exact(
        "headline E=2", data, queries, ids_w, d_w, metric)
    out["beam_width_2"]["recall_at_10"] = recall_of(ids_w, truth, k)
    subset = np.sort(np.random.default_rng(0xF17).choice(
        len(data), len(data) // 10, replace=False))
    ids_f, d_f, out["filter_10pct"] = timed_search(
        torch, kernels, kernel, coord, queries, k, "headline filter 10%",
        allowed_rowids=subset, batch_size=batch,
    )
    found = ids_f[ids_f >= 0]
    if not np.isin(found, subset).all():
        raise AssertionError("filtered search returned a row outside the set")
    out["filter_10pct"]["max_dist_err"] = check_exact(
        "headline filter", data, queries, ids_f, d_f, metric)
    sub_truth = subset[exact_topk(
        torch, dev, data[subset], queries, k, coord.params.metric)]
    out["filter_10pct"]["recall_at_10"] = recall_of(ids_f, sub_truth, k)
    out["filter_10pct"]["results_per_query"] = len(found) / len(queries)
    log(f"headline: E=2 recall@10 {out['beam_width_2']['recall_at_10']:.4f}; "
        f"filter recall@10 vs the subset's scan "
        f"{out['filter_10pct']['recall_at_10']:.4f}, "
        f"{out['filter_10pct']['results_per_query']:.2f} results/query")
    return out


def serve_hard(torch, dev, kernels, kernel, coord, data, queries, ids,
               truth, k, metric, batch):
    """HARD: streaming lanes with and without adaptive seeds, each identical
    to the lock-step batches of the same options; strict recall printed."""
    out = {}
    adaptive = dict(adaptive_seeds=2, seed_sample=4096)
    runs = (
        ("stream_512", dict(stream=True, lanes=batch), ids),
        ("adaptive_lockstep_512", dict(batch_size=batch, **adaptive), None),
        ("adaptive_stream_512", dict(stream=True, lanes=batch, **adaptive),
         "adaptive_lockstep_512"),
    )
    got = {}
    for name, opts, want in runs:
        got[name], d, out[name] = timed_search(
            torch, kernels, kernel, coord, queries, k, f"hard {name}", **opts
        )
        if want is not None:
            want_ids = got[want] if isinstance(want, str) else want
            if not np.array_equal(got[name], want_ids):
                bad = int((got[name] != want_ids).any(-1).sum())
                raise AssertionError(
                    f"hard {name}: rowids != lock-step on {bad} queries")
        out[name]["max_dist_err"] = check_exact(
            f"hard {name}", data, queries, got[name], d, metric)
        out[name]["recall_at_10"] = recall_of(got[name], truth, k)
    log(f"hard: strict recall@10 stream {out['stream_512']['recall_at_10']:.4f}"
        f", adaptive stream {out['adaptive_stream_512']['recall_at_10']:.4f}")
    return out


SERVE = {"int4_headline": serve_headline, "hard": serve_hard}


def run_ab_stream(torch, kernels, kernel, coord, queries, k, l_search, batch):
    """``experiments/ab_stream.py`` on the headline graph (before its
    lifecycle, while ``assume_all_valid`` holds): lock-step batches of
    ``batch`` against the stream at 512, 1,024 and 2,048 lanes on the
    queries' whole batches. The id match is printed; ab_stream holds
    lanes == ``batch`` to 1.0."""
    from duckdb_lm_diskann_tpu_torch.experiments import ab_stream

    whole = len(queries) // batch * batch
    reset_counts(kernels)
    t0 = time.perf_counter()
    out = ab_stream.compare(
        coord, queries[:whole], k=k, l_search=l_search, batch=batch, reps=1,
        out=lambda line: print(f"ab_stream {line}", flush=True))
    out["launches"] = check_launches(kernels, kernel, "ab_stream")
    out["s"] = time.perf_counter() - t0
    log(f"ab_stream took {out['s']:.1f} s, {out['launches']} launches")
    return out


# The smoke's subset of ab_hard_recall's twelve configurations (the run's
# time): each seed count, sample size and L once, and both W2 rows.
HARD_GRID = ("adaptive s2 m4096 L100", "adaptive s4 m8192 L100",
             "adaptive s8 m8192 L150", "adaptive s8 m16384 L150",
             "adaptive s8 m8192 L200", "W2 s8 m8192 L100", "W2 s8 m8192 L150")


def run_ab_hard_recall(torch, kernels, kernel, coord, data, queries, truth,
                       k, reps=1):
    """``experiments/ab_hard_recall.py``'s baseline and the HARD_GRID
    configurations on the refined HARD graph, against the path's exact
    top-k (its k-th distance in f64 for the eps-recall), ``reps`` timed
    calls each after the first. Printed only: HARD's recall is not held."""
    from duckdb_lm_diskann_tpu_torch.experiments import ab_hard_recall

    grid = [c for c in ab_hard_recall.CONFIGS if c[0] in HARD_GRID]
    if len(grid) != len(HARD_GRID):
        raise AssertionError(f"ab_hard_recall: {HARD_GRID} not all found")

    truth_dists = np.sort(exact_distances(queries, data[truth], "l2"), 1)
    reset_counts(kernels)
    t0 = time.perf_counter()
    rows = ab_hard_recall.sweep(
        coord, queries, truth, truth_dists, k=k, reps=reps,
        configs=(ab_hard_recall.BASELINE, *grid),
        out=lambda line: print(f"ab_hard_recall {line}", flush=True))
    out = {"reps": reps, "rows": [
        {key: v for key, v in row.items() if key != "ids"} for row in rows]}
    out["launches"] = check_launches(kernels, kernel, "ab_hard_recall")
    out["s"] = time.perf_counter() - t0
    log(f"ab_hard_recall took {out['s']:.1f} s, {out['launches']} launches")
    return out


def run_profile_insert(torch, kernels, kernel, coord, data, max_batch, label):
    """``experiments/profile_insert.py`` as a path's last step: 3 x
    ``max_batch`` new rows (corpus rows plus seeded noise, under fresh row
    ids from len(data)); two steady batches inserted, then the candidate
    search at widths 1 and 2 on the third batch."""
    from duckdb_lm_diskann_tpu_torch.experiments import profile_insert

    n, m = len(data), 3 * max_batch
    rng = np.random.default_rng(0x1A5E)
    rows = data[rng.integers(0, n, m)] + 0.01 * rng.standard_normal(
        (m, data.shape[1])).astype(np.float32)
    reset_counts(kernels)
    out = profile_insert.profile(
        coord, range(n, n + m), rows, max_batch,
        out=lambda line: print(f"profile_insert {label} {line}", flush=True))
    out["launches"] = check_launches(kernels, kernel,
                                     f"{label} profile_insert")
    return out

# bench.py:635-652: two delete batches of this many rows, cold then steady.
DELETE_ROWS = 1000


def lifecycle_headline(torch, dev, kernels, kernel, coord, data, queries,
                       truth, rng, k, metric, batch):
    """The lifecycle on the headline graph, after its serving searches (as
    bench.py orders them): two deletes of DELETE_ROWS rows picked from the
    path's rng (bench.py:641), cold then steady, each timed with its device
    work (the steady one phase by phase by experiments/profile_delete.py);
    the lock-step queries against a scan of the live rows; vacuum (2 *
    DELETE_ROWS slots recycled, full reachability); the deleted rows
    re-inserted into the recycled slots; the queries again against the
    whole corpus. Returns its metrics with the INT4 launches per phase."""
    from duckdb_lm_diskann_tpu_torch.experiments import profile_delete
    from duckdb_lm_diskann_tpu_torch.utils.verify import verify_graph

    out, launches = {}, {}
    n = len(data)
    picks = rng.choice(n, 2 * DELETE_ROWS, replace=False)
    freed = coord.allocator.lookup_slots(picks)

    reset_counts(kernels)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if coord.delete(picks[:DELETE_ROWS].tolist()) != DELETE_ROWS:
        raise AssertionError("headline delete: rows missing")
    torch.cuda.synchronize(dev)
    out["delete_cold_ms_per_row"] = (
        1e3 * (time.perf_counter() - t0) / DELETE_ROWS)
    prof = profile_delete.profile(coord, picks[DELETE_ROWS:])
    if prof["rows"] != DELETE_ROWS:
        raise AssertionError(f"headline delete: {prof['rows']} rows")
    out["delete_ms_per_row"] = prof["ms_per_row"]
    out["delete_profile"] = prof
    launches["delete"] = sum(m.LAUNCHES for m in kernels.values())
    log(f"headline delete: cold {out['delete_cold_ms_per_row']:.3f} ms/row, "
        f"steady {out['delete_ms_per_row']:.3f} ms/row, phases (ms) "
        f"{ {p: round(t, 1) for p, t in prof['phases_ms'].items()} }, "
        f"{prof['rounds']} repair rounds")

    ids, dists, m = timed_search(
        torch, kernels, kernel, coord, queries, k, "headline after delete",
        batch_size=batch,
    )
    if np.isin(ids, picks).any():
        raise AssertionError("headline: a deleted row came back")
    live = np.setdiff1d(np.arange(n), picks)
    live_truth = live[exact_topk(torch, dev, data[live], queries, k,
                                 coord.params.metric)]
    m["recall_at_10"] = recall_of(ids, live_truth, k)
    m["max_dist_err"] = check_exact("headline after delete", data, queries,
                                    ids, dists, metric)
    if m["recall_at_10"] < 0.95:
        raise AssertionError(f"headline after delete: recall {m}")
    out["search_after_delete"] = m
    launches["search_after_delete"] = m["launches"]

    reset_counts(kernels)
    t0 = time.perf_counter()
    recycled = coord.vacuum()
    torch.cuda.synchronize(dev)
    out["vacuum_s"] = time.perf_counter() - t0
    out["vacuum_relinked"] = coord.last_relinked
    launches["vacuum"] = kernel.LAUNCHES
    if recycled != 2 * DELETE_ROWS:
        raise AssertionError(f"vacuum recycled {recycled} slots")
    if any(mod.LAUNCHES for mod in kernels.values() if mod is not kernel):
        raise AssertionError("vacuum launched another codec's kernel")
    out["reachable_fraction"] = verify_graph(coord)["reachable_fraction"]
    if out["reachable_fraction"] != 1.0:
        raise AssertionError(f"after vacuum: {out['reachable_fraction']}")

    reset_counts(kernels)
    t0 = time.perf_counter()
    coord.insert(picks.tolist(), data[picks])
    torch.cuda.synchronize(dev)
    out["reinsert_s"] = time.perf_counter() - t0
    launches["reinsert"] = check_launches(kernels, kernel, "headline re-insert")
    if not np.isin(coord.allocator.lookup_slots(picks), freed).all():
        raise AssertionError("a re-inserted row missed the recycled slots")

    ids, dists, m = timed_search(
        torch, kernels, kernel, coord, queries, k, "headline after re-insert",
        batch_size=batch,
    )
    m["recall_at_10"] = recall_of(ids, truth, k)
    m["max_dist_err"] = check_exact("headline after re-insert", data,
                                    queries, ids, dists, metric)
    if m["recall_at_10"] < 0.95:
        raise AssertionError(f"headline after re-insert: recall {m}")
    out["search_after_reinsert"] = m
    launches["search_after_reinsert"] = m["launches"]
    out["launches"] = launches
    log(f"headline lifecycle: after delete recall@10 "
        f"{out['search_after_delete']['recall_at_10']:.4f}; vacuum "
        f"{out['vacuum_s']:.2f} s, {out['vacuum_relinked']} relinked, "
        f"reachable {out['reachable_fraction']}; re-insert "
        f"{out['reinsert_s']:.2f} s; recall@10 {m['recall_at_10']:.4f}; "
        f"INT4 launches {launches}")
    return out


# Single queries of the SQL phase: this many through the index scan, then
# as many brute-force scans of the whole column of a table with no index.
SQL_SINGLE_QUERIES = 16


def _expected_after_reload(torch, coord, name, saved):
    """``saved`` (a graph table of ``coord`` up to high water) as a
    checkpoint gives it back: a dead slot's block is written zeroed (its
    neighbor ids decode as row 0, which maps to row 0's slot when row 0
    lives), and an edge into a dead row is written empty."""
    hw = coord.allocator.high_water
    valid = coord.arrays.valid[:hw]
    if name == "valid":
        return saved
    if name == "dirty_rows":
        return torch.zeros_like(saved)
    if name == "neighbors":
        live = torch.as_tensor(coord._slot_rowids >= 0, device=saved.device)
        kept = torch.where(
            (saved >= 0) & live[saved.clamp_min(0).long()], saved, -1)
        dead = coord.allocator.rowid_to_slot.get(0, -1)
        return torch.where(valid[:, None], kept, torch.full_like(saved, dead))
    mask = valid.view((-1,) + (1,) * (saved.dim() - 1))
    return torch.where(mask, saved, torch.zeros_like(saved))


def check_reopened(torch, coord, reopened):
    """Every table up to high water, the allocator maps and the entry of
    ``reopened`` equal ``coord``'s as its checkpoint gives them back."""
    hw = coord.allocator.high_water
    for name in type(coord.arrays)._fields:
        want = _expected_after_reload(
            torch, coord, name, getattr(coord.arrays, name)[:hw])
        got = getattr(reopened.arrays, name)[:hw]
        if got.dtype != want.dtype or not bool((got == want).all()):
            raise AssertionError(f"reopened index: table {name} differs")
    a, b = coord.allocator, reopened.allocator
    for key in ("rowid_to_slot", "slot_to_rowid", "free_slots",
                "pending_deletion", "high_water"):
        if getattr(a, key) != getattr(b, key):
            raise AssertionError(f"reopened index: allocator {key} differs")
    a, b = coord._slot_rowids, reopened._slot_rowids
    if not (np.array_equal(a[:hw], b[:hw]) and (a[hw:] < 0).all()
            and (b[hw:] < 0).all()):
        raise AssertionError("reopened index: slot -> rowid map differs")
    if (coord.entry_slot, coord.entry_rowid) != (
            reopened.entry_slot, reopened.entry_rowid):
        raise AssertionError("reopened index: entry point differs")


def store_db_headline(torch, dev, kernels, kernel, coord, data, queries,
                      truth, rng, k, batch, options, keep_dir=False):
    """Persistence and the SQL surface on the headline index, after its
    lifecycle: a full save into ``<tmp>/db.lmd_idx/headline``; a Database
    on ``<tmp>/db`` whose ``create_index`` reopens that checkpoint (no
    build) into tables equal to the saved ones, answering the headline
    queries with the pre-save ids and distances; single ``knn`` queries
    through the index scan, ``knn_join`` over the queries, brute-force
    scans of a table with no index, the index pragma; a 1,000-row delete
    and an incremental ``checkpoint``; the CLI's ``bench`` in a
    subprocess on the incremental checkpoint; every ``tests/sql`` file
    replayed on the card. Returns its metrics and the launches of each
    kernel per step (the CLI's own process is not counted). ``keep_dir``:
    the directory (``tmp_dir``: the incremental checkpoint and the CLI's
    ``cli_ids.npy``) outlives the phase, for the ``parallel`` phase, which
    removes it."""
    import shutil
    import tempfile
    from pathlib import Path

    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.db import planner
    from duckdb_lm_diskann_tpu_torch.db.database import connect
    from duckdb_lm_diskann_tpu_torch.db.sqltest import run_sqllogic_file
    from duckdb_lm_diskann_tpu_torch.store import checkpoint
    from duckdb_lm_diskann_tpu_torch.store.block_codec import resolve_layout

    root = Path(__file__).resolve().parent
    out, launches = {}, {}
    n, hw = len(data), coord.allocator.high_water
    block = resolve_layout(coord.config).block_size
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
    try:
        free = shutil.disk_usage(tmp).free
        out.update(tmp_dir=str(tmp), tmp_free_bytes=free, block_bytes=block)
        log(f"store: {tmp} has {free / 1e9:.1f} GB free; the checkpoint "
            f"takes {hw * block / 1e9:.2f} GB")
        if free < 2 * hw * block:
            raise AssertionError(f"store: {free} bytes free in {tmp}")

        ids0, d0, out["search_before_save"] = timed_search(
            torch, kernels, kernel, coord, queries, k, "headline before save",
            batch_size=batch)
        launches["search_before_save"] = out["search_before_save"]["launches"]

        index_dir = tmp / "db.lmd_idx" / "headline"
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        saved = checkpoint.save_index(coord, index_dir)
        out["save_s"] = time.perf_counter() - t0
        out["graph_bytes"] = (index_dir / "graph.lmd").stat().st_size
        out["save_gb_per_s"] = out["graph_bytes"] / out["save_s"] / 1e9
        out["save"] = saved
        if (saved["incremental"] or saved["backend"] != "native"
                or saved["blocks_written"] != hw or saved["high_water"] != hw):
            raise AssertionError(f"store: full save {saved}")
        log(f"store: full save of {saved['blocks_written']} blocks "
            f"(== high water {hw}), {out['graph_bytes']} bytes in "
            f"{out['save_s']:.2f} s ({out['save_gb_per_s']:.2f} GB/s), "
            f"{saved['backend']} block store")

        db = connect(str(tmp / "db"))
        t = db.create_table("headline", {"vec": data})
        live = np.fromiter(sorted(coord.allocator.rowid_to_slot), np.int64)
        if not np.array_equal(t.row_ids, live):
            raise AssertionError("store: table rows != the index's live rows")

        def no_build(self, *a, **kw):
            raise AssertionError("create_index rebuilt the checkpointed index")

        reset_counts(kernels)
        real_build = Coordinator.bulk_build
        Coordinator.bulk_build = no_build
        try:
            t0 = time.perf_counter()
            idx = db.create_index("headline", t, "vec", options=options)
            torch.cuda.synchronize(dev)
            out["reopen_s"] = time.perf_counter() - t0
        finally:
            Coordinator.bulk_build = real_build
        if any(m.LAUNCHES for m in kernels.values()):
            raise AssertionError("store: create_index launched a kernel")
        reopened = idx.coordinator
        if reopened.device.type != "cuda":
            raise AssertionError(f"store: reopened on {reopened.device}")
        t0 = time.perf_counter()
        check_reopened(torch, coord, reopened)
        out["check_s"] = time.perf_counter() - t0
        log(f"store: create_index reopened the checkpoint in "
            f"{out['reopen_s']:.2f} s (warm page cache, no build, no "
            "launches); tables, maps and entry equal the saved index's "
            f"(compared in {out['check_s']:.1f} s)")

        ids1, d1, out["search_reopened"] = timed_search(
            torch, kernels, kernel, reopened, queries, k,
            "headline reopened", batch_size=batch)
        launches["search_reopened"] = out["search_reopened"]["launches"]
        if not (np.array_equal(ids1, ids0) and np.array_equal(d1, d0)):
            bad = int((ids1 != ids0).any(-1).sum())
            raise AssertionError(
                f"store: reopened search differs on {bad} queries")

        reset_counts(kernels)
        lat, got = [], []
        for i in range(SQL_SINGLE_QUERIES):
            t0 = time.perf_counter()
            res, plan = db.knn(t, "vec", queries[i], k, return_plan=True)
            lat.append(time.perf_counter() - t0)
            if not isinstance(plan, planner.LogicalIndexScan):
                raise AssertionError(f"store: knn plan {type(plan).__name__}")
            got.append(res["row_ids"])
        launches["knn"] = check_launches(kernels, kernel, "store knn")
        out["knn_b1_ms_median"] = 1e3 * float(np.median(lat))
        for i, ids in enumerate(got):
            want, _ = reopened.search(queries[i : i + 1], k)
            if not np.array_equal(ids, want[0][want[0] >= 0]):
                raise AssertionError(f"store: knn query {i} != Coordinator")

        reset_counts(kernels)
        t0 = time.perf_counter()
        res, plan = db.knn_join(t, "vec", queries, k, return_plan=True)
        secs = time.perf_counter() - t0
        launches["knn_join"] = check_launches(kernels, kernel, "store knn_join")
        if not isinstance(plan, planner.LogicalKnnJoin):
            raise AssertionError(f"store: knn_join plan {type(plan).__name__}")
        out["knn_join_qps"] = len(queries) / secs
        out["knn_join_recall_at_10"] = recall_of(
            res["row_ids"].reshape(-1, k), truth, k)
        if out["knn_join_recall_at_10"] < 0.95:
            raise AssertionError(f"store: knn_join recall {out}")

        scan = db.create_table("headline_scan", {"vec": data})
        reset_counts(kernels)
        lat = []
        for i in range(SQL_SINGLE_QUERIES):
            t0 = time.perf_counter()
            res, plan = db.knn(scan, "vec", queries[i], k, return_plan=True)
            lat.append(time.perf_counter() - t0)
            if not isinstance(plan, planner.LogicalTopN):
                raise AssertionError(f"store: scan plan {type(plan).__name__}")
            if not np.array_equal(res["row_ids"], truth[i]):
                raise AssertionError(f"store: scan query {i} != exact top-k")
        if any(m.LAUNCHES for m in kernels.values()):
            raise AssertionError("store: the brute-force scan launched")
        out["scan_ms_median"] = 1e3 * float(np.median(lat))
        (info,) = db.pragma_lm_diskann_index_info()
        if info["count"] != n or info["index_name"] != "headline":
            raise AssertionError(f"store: pragma {info}")
        out["pragma"] = {key: info[key] for key in (
            "count", "capacity", "approx_memory_size", "block_size",
            "degree_stats")}
        log(f"store: knn B=1 median {out['knn_b1_ms_median']:.2f} ms "
            f"(index scan, ids == Coordinator); knn_join "
            f"{out['knn_join_qps']:.0f} QPS, recall@10 "
            f"{out['knn_join_recall_at_10']:.4f}; brute-force scan median "
            f"{out['scan_ms_median']:.1f} ms (== exact top-k); pragma "
            f"{out['pragma']}")

        victims = rng.choice(n, DELETE_ROWS, replace=False)
        reset_counts(kernels)
        t0 = time.perf_counter()
        t.delete(victims.tolist())
        torch.cuda.synchronize(dev)
        out["delete_s"] = time.perf_counter() - t0
        dirty = int(reopened.arrays.dirty_rows[:hw].sum())
        t0 = time.perf_counter()
        saved = db.checkpoint()["headline.headline"]
        out["incremental_s"] = time.perf_counter() - t0
        out["incremental"] = saved
        if (not saved["incremental"] or saved["backend"] != "native"
                or saved["blocks_written"] != dirty or dirty >= hw):
            raise AssertionError(f"store: incremental save {saved}, {dirty}")
        log(f"store: deleted {DELETE_ROWS} rows in {out['delete_s']:.2f} s; "
            f"incremental checkpoint wrote the {dirty} dirty blocks of {hw} "
            f"in {out['incremental_s']:.2f} s")

        q_path, ids_path = tmp / "queries.npy", tmp / "cli_ids.npy"
        np.save(q_path, queries)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{_PKG}.cli", "bench", "--db",
             str(tmp / "db"), "--index", "headline", "--queries", str(q_path),
             "--k", str(k), "--out", str(ids_path)],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        out["cli_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"store: cli bench failed\n{proc.stderr}")
        bench = json.loads(proc.stdout.strip().splitlines()[-1])
        out["cli_bench"] = bench
        cli_ids = np.load(ids_path)
        if (bench["recall_at_k"] < 0.95 or not bench["device"].startswith("cuda")
                or np.isin(cli_ids, victims).any()):
            raise AssertionError(f"store: cli bench {bench}")
        log(f"store: cli bench (a process of its own, {out['cli_s']:.1f} s "
            f"with its load) {bench['qps']} QPS, recall@10 "
            f"{bench['recall_at_k']} vs the live rows, no deleted row")

        files = {}
        sql_launches = dict.fromkeys(("int4", "ternary", "int8"), 0)
        t0 = time.perf_counter()
        for path in sorted((root / "tests" / "sql").glob("*.sql.test")):
            reset_counts(kernels)
            files[path.name] = run_sqllogic_file(path)
            for codec in sql_launches:
                sql_launches[codec] += kernels[codec].LAUNCHES
        if len(files) < 22 or not (sql_launches["ternary"]
                                   and sql_launches["int8"]):
            raise AssertionError(f"store: sql files {files} {sql_launches}")
        out["sql_files"] = files
        out["sql_files_s"] = time.perf_counter() - t0
        launches["sql_files"] = sql_launches
        log(f"store: {len(files)} SQL files replayed on the card in "
            f"{out['sql_files_s']:.1f} s, {sum(files.values())} directives "
            f"({files}); launches {sql_launches}")
        del db, t, scan, idx, reopened
    except BaseException:
        shutil.rmtree(tmp)
        raise
    if not keep_dir:
        shutil.rmtree(tmp)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"store: the phase took {out['phase_s']:.1f} s")
    return out


# The parallel phase's sizes: the disjoint index, the distributed build
# and delete, and the multi-process disjoint index (two shards a process;
# MULTIHOST_ROWS under --multihost-only). Cut for the run's time: a whole
# default run took 957.3 s on a fast host and passed 1,200 s on a host
# ~1.4x slower (NVIDIA H100 80GB HBM3, 700 W), when the disjoint index held
# the whole headline (4 x 250,000), the distributed build 65,536 rows and
# the multi-process index 262,144.
DISJOINT_ROWS = 262_144
DIST_BUILD_ROWS = 32_768
PHASE_MULTIHOST_ROWS = 65_536
MULTIHOST_ROWS = 262_144
MULTIHOST_TIMEOUT_S = 900
# The global graph across the processes: rows and queries of its checks.
MULTIHOST_GLOBAL_ROWS = 16_384
MULTIHOST_GLOBAL_QUERIES = 1024


def _block_bytes(arrays, s=0):
    """Bytes of row block ``s`` of every table of row-sharded arrays."""
    return sum(t.blocks[s].numel() * t.blocks[s].element_size() for t in arrays)


def _same_tables(torch, one, g):
    """Fields whose rows differ between a Coordinator's tables and the row
    blocks of a distributed index (compared block by block on the card;
    across processes, the blocks this process holds)."""
    bad = []
    for name in one.arrays._fields:
        full, sharded = getattr(one.arrays, name), getattr(g.coordinator.arrays, name)
        rows = sharded.rows
        for s, blk in sharded._local():
            a = full[s * rows : (s + 1) * rows]
            if not torch.equal(a, blk[: a.shape[0]]):
                diff = (a != blk[: a.shape[0]]).reshape(a.shape[0], -1).any(-1)
                bad.append((name, s * rows + int(torch.nonzero(diff)[0])))
                break
    return bad


def parallel_headline(torch, dev, kernels, kernel, coord, cfg, data, queries,
                      rng, k, batch, store_dir):
    """The sharded engines (``parallel/``) on the headline, after
    ``store_db`` (whose directory, ``store_dir``, it removes):

    - global mode on the headline index: ``GlobalShardedIndex(coord,
      [card] * 4)`` distributed into four row blocks; its search at the
      headline's batches equals the Coordinator's (ids, distances, hops);
      ``load_global_sharded`` of ``store_db``'s incremental checkpoint
      answers with the ids of the CLI's ``bench`` on it (batches of 256);
    - disjoint shards: ``ShardedIndex`` over four shards on the card,
      built from the corpus' first DISJOINT_ROWS rows; its answer equals
      the merge of its four Coordinators' own searches, recall@10 >= 0.95
      against those rows' exact top-k, exact distances; ``save`` ->
      ``load_sharded`` -> the same answer;
    - ``distributed_build`` of the corpus' first DIST_BUILD_ROWS rows into
      four row blocks: every table and the entry equal
      ``Coordinator.bulk_build``'s; then DELETE_ROWS rows deleted and a
      vacuum on both: equal tables again;
    - multi-process: ``torch.cuda.device_count()`` processes (this script
      with ``--multihost-worker``), NCCL, two shards each, over the first
      PHASE_MULTIHOST_ROWS rows: ids and distances equal a one-process
      ``ShardedIndex`` over the same shards; and the global graph across
      those processes (``multihost_global``).

    Returns its metrics and the INT4 launches of each step in this
    process."""
    import shutil
    import tempfile
    from pathlib import Path

    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.parallel.global_graph import (
        GlobalShardedIndex,
        load_global_sharded,
    )
    from duckdb_lm_diskann_tpu_torch.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu_torch.parallel.sharded import (
        ShardedIndex,
        load_sharded,
    )

    out, launches = {}, {}
    n = len(data)
    t_phase = time.perf_counter()
    tmp = Path(store_dir)
    mesh4 = make_mesh([dev] * 4)
    try:
        # -- global mode on the headline index ------------------------- #
        ids0, d0, out["headline_search"] = timed_search(
            torch, kernels, kernel, coord, queries, k,
            "parallel: headline Coordinator", batch_size=batch)
        launches["headline_search"] = out["headline_search"]["launches"]
        g = GlobalShardedIndex(coord, mesh=mesh4)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stacked = g.distribute()
        torch.cuda.synchronize(dev)
        out["distribute_s"] = time.perf_counter() - t0
        out["row_block_bytes"] = _block_bytes(stacked)
        out["single_table_bytes"] = coord.get_in_memory_size()
        ids1, d1, out["global_search"] = timed_search(
            torch, kernels, kernel, g, queries, k,
            "parallel: global mode, 4 row blocks", batch_size=batch)
        launches["global_search"] = out["global_search"]["launches"]
        if not (np.array_equal(ids1, ids0) and np.array_equal(d1, d0)
                and out["global_search"]["hops"] == out["headline_search"]["hops"]):
            bad = int((ids1 != ids0).any(-1).sum())
            raise AssertionError(f"parallel: global search differs on {bad} "
                                 "queries, or in hops")
        if launches["global_search"] % 4:
            raise AssertionError("parallel: the kernel did not launch per block")
        log(f"parallel: global mode == the Coordinator (ids, distances, "
            f"{out['global_search']['hops']} hops); a row block holds "
            f"{out['row_block_bytes'] / 1e9:.3f} GB of the "
            f"{out['single_table_bytes'] / 1e9:.3f} GB table "
            f"(distributed in {out['distribute_s']:.4f} s)")
        del g, stacked
        _free(torch)

        cli_ids = np.load(tmp / "cli_ids.npy")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        gl = load_global_sharded(tmp / "db.lmd_idx" / "headline", mesh=mesh4)
        torch.cuda.synchronize(dev)
        out["load_global_s"] = time.perf_counter() - t0
        ids2, _, out["global_loaded_search"] = timed_search(
            torch, kernels, kernel, gl, queries, k,
            "parallel: load_global_sharded, batches of 256", batch_size=256)
        launches["global_loaded_search"] = out["global_loaded_search"]["launches"]
        if not np.array_equal(ids2, cli_ids):
            raise AssertionError("parallel: the loaded global index != CLI ids")
        out["load_global_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        log(f"parallel: load_global_sharded of store_db's checkpoint in "
            f"{out['load_global_s']:.2f} s; ids == the CLI bench's")
        del gl
        _free(torch)
    finally:
        shutil.rmtree(tmp)

    # -- disjoint shards over the corpus' first DISJOINT_ROWS rows ----- #
    nd = min(DISJOINT_ROWS, n)
    sub = data[:nd]
    truth_d = exact_topk(torch, dev, sub, queries, k, cfg.metric_type)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(kernels)
    t0 = time.perf_counter()
    idx = ShardedIndex(cfg, mesh=mesh4)
    idx.build(range(nd), sub, max_batch=2048)
    torch.cuda.synchronize(dev)
    out["disjoint_rows"] = nd
    out["disjoint_build_s"] = time.perf_counter() - t0
    out["disjoint_inserts_per_s"] = nd / out["disjoint_build_s"]
    launches["disjoint_build"] = check_launches(kernels, kernel, "disjoint build")
    reset_counts(kernels)
    t0 = time.perf_counter()
    ids, dists = idx.search(queries, k)
    secs = time.perf_counter() - t0
    launches["disjoint_search"] = check_launches(kernels, kernel, "disjoint search")
    out["disjoint_search_s"] = secs
    out["disjoint_qps"] = len(queries) / secs
    out["disjoint_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    per = [c.search(queries, k) for c in idx.coordinators]
    u_ids = np.concatenate([i for i, _ in per], 1)
    u_d = np.concatenate([d for _, d in per], 1)
    order = np.stack([np.lexsort((u_ids[b], u_d[b]))[:k]
                      for b in range(len(queries))])
    if not (np.array_equal(ids, np.take_along_axis(u_ids, order, 1))
            and np.array_equal(dists, np.take_along_axis(u_d, order, 1))):
        raise AssertionError("parallel: disjoint answer != the shards' merge")
    out["disjoint_recall_at_10"] = recall_of(ids, truth_d, k)
    out["disjoint_max_dist_err"] = check_exact(
        "parallel disjoint", sub, queries, ids, dists, "l2")
    if out["disjoint_recall_at_10"] < 0.95:
        raise AssertionError(f"parallel: disjoint recall {out}")
    log(f"parallel: disjoint 4 x {nd // 4} built in "
        f"{out['disjoint_build_s']:.1f} s ({out['disjoint_inserts_per_s']:.0f}"
        f" inserts/s, {launches['disjoint_build']} launches); search "
        f"{out['disjoint_qps']:.0f} QPS (one batch of {len(queries)} a "
        f"shard), recall@10 {out['disjoint_recall_at_10']:.5f}, == the merge "
        f"of the shards' searches; peak {out['disjoint_peak_bytes'] / 1e9:.3f}"
        f" GB; {launches['disjoint_search']} launches")
    sdir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        t0 = time.perf_counter()
        idx.save(sdir)
        out["disjoint_save_s"] = time.perf_counter() - t0
        del idx
        _free(torch)
        t0 = time.perf_counter()
        back = load_sharded(sdir, mesh=mesh4)
        torch.cuda.synchronize(dev)
        out["disjoint_load_s"] = time.perf_counter() - t0
        reset_counts(kernels)
        ids_b, d_b = back.search(queries, k)
        launches["disjoint_reloaded"] = check_launches(
            kernels, kernel, "disjoint reloaded")
        if not (np.array_equal(ids_b, ids) and np.array_equal(d_b, dists)):
            raise AssertionError("parallel: load_sharded answers differ")
        del back
        _free(torch)
    finally:
        shutil.rmtree(sdir)
    log(f"parallel: disjoint save {out['disjoint_save_s']:.1f} s, "
        f"load_sharded {out['disjoint_load_s']:.1f} s, the same answers")

    # -- distributed build, delete, vacuum ----------------------------- #
    m = min(DIST_BUILD_ROWS, n)
    sub = data[:m]
    one = Coordinator(cfg, initial_capacity=m)
    one.bulk_build(range(m), sub, max_batch=2048)
    reset_counts(kernels)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    g = GlobalShardedIndex(Coordinator(cfg), mesh=mesh4)
    g.distributed_build(range(m), sub, max_batch=2048)
    torch.cuda.synchronize(dev)
    out["distributed_build_s"] = time.perf_counter() - t0
    launches["distributed_build"] = check_launches(
        kernels, kernel, "distributed build")
    bad = _same_tables(torch, one, g)
    if bad or g.coordinator.entry_slot != one.entry_slot:
        raise AssertionError(
            f"parallel: distributed build != bulk_build: {bad}, entry "
            f"{g.coordinator.entry_slot} vs {one.entry_slot}")
    victims = rng.choice(m, DELETE_ROWS, replace=False).tolist()
    reset_counts(kernels)
    t0 = time.perf_counter()
    g.delete(victims)
    g.vacuum()
    torch.cuda.synchronize(dev)
    out["distributed_delete_vacuum_s"] = time.perf_counter() - t0
    launches["distributed_dml"] = kernel.LAUNCHES
    one.delete(victims)
    one.vacuum()
    bad = _same_tables(torch, one, g)
    if bad or g.coordinator.entry_slot != one.entry_slot:
        raise AssertionError(f"parallel: tables after delete + vacuum: {bad}")
    log(f"parallel: distributed_build of {m} rows in "
        f"{out['distributed_build_s']:.1f} s == bulk_build (every table, the "
        f"entry); delete {DELETE_ROWS} + vacuum "
        f"{out['distributed_delete_vacuum_s']:.2f} s == the Coordinator's")
    del one, g
    _free(torch)

    # -- multi-process disjoint shards (NCCL) -------------------------- #
    out["multihost"] = run_multihost(torch, kernels, kernel, cfg, data, queries,
                                     k, PHASE_MULTIHOST_ROWS)
    launches["multihost_reference"] = out["multihost"]["reference_launches"]
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel: the phase took {out['phase_s']:.1f} s")
    return out


def run_multihost(torch, kernels, kernel, cfg, data, queries, k, rows):
    """``torch.cuda.device_count()`` processes (this script with
    ``--multihost-worker``), NCCL, two disjoint shards each on its own card,
    over the first ``rows`` rows of ``data``: the merged answer
    (ids and distances) must equal a one-process ``ShardedIndex`` over the
    same shards on the same cards. A worker that fails or outlives
    MULTIHOST_TIMEOUT_S fails the run. Returns the workers' numbers and the
    reference's INT4 launches in this process."""
    import shutil
    import socket
    import tempfile
    from pathlib import Path

    from duckdb_lm_diskann_tpu_torch.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu_torch.parallel.sharded import ShardedIndex

    mh = min(rows, len(data))
    world = torch.cuda.device_count()
    wdir = Path(tempfile.mkdtemp(prefix="chip_smoke_multihost_"))
    try:
        np.save(wdir / "rows.npy", data[:mh])
        np.save(wdir / "queries.npy", queries)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        init = f"tcp://127.0.0.1:{port}"
        t0 = time.perf_counter()
        logs = [open(wdir / f"worker{r}.log", "w") for r in range(world)]
        procs = [
            subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--multihost-worker", str(r), str(world), init, str(wdir)],
                cwd=Path(__file__).resolve().parent,
                stdout=logs[r], stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]
        # A worker that fails leaves the others waiting in a collective:
        # the first failure (or the time limit) ends them all.
        try:
            while any(p_.poll() is None for p_ in procs):
                if (any(p_.returncode not in (None, 0) for p_ in procs)
                        or time.perf_counter() - t0 > MULTIHOST_TIMEOUT_S):
                    break
                time.sleep(0.2)
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
            for f in logs:
                f.close()
        wall_s = time.perf_counter() - t0
        bad = [r for r, p_ in enumerate(procs) if p_.returncode != 0]
        if bad:  # the report shows a worker that failed on its own first
            r = min(bad, key=lambda r: procs[r].returncode < 0)
            text = (wdir / f"worker{r}.log").read_text()
            raise AssertionError(
                f"parallel: multihost worker {r} exited {procs[r].returncode} "
                f"after {wall_s:.1f} s (failed: {bad})\n{text[-4000:]}")
        res = json.loads((wdir / "rank0.json").read_text())
        mids = np.load(wdir / "ids.npy")
        md = np.load(wdir / "dists.npy")
    finally:
        shutil.rmtree(wdir)
    reset_counts(kernels)
    t0 = time.perf_counter()
    single = ShardedIndex(cfg, mesh=make_mesh(
        [torch.device("cuda", r) for r in range(world) for _ in range(2)]))
    single.build(range(mh), data[:mh], max_batch=2048)
    ref_build_s = time.perf_counter() - t0
    sids, sd = single.search(queries, k)
    ref_launches = check_launches(kernels, kernel, "one-process reference")
    if not (np.array_equal(mids, sids) and np.array_equal(md, sd)):
        bad = int((mids != sids).any(-1).sum())
        raise AssertionError(
            f"parallel: multi-process answer != one process on {bad} queries")
    log(f"parallel: {world} process(es) x 2 shards over {mh} rows "
        f"({res['backend']}): build {res['build_s']:.1f} s "
        f"({res['inserts_per_s']:.0f} inserts/s), search {res['qps']:.0f} "
        f"QPS, {res['launches']} launches in process 0; ids and distances "
        f"== one process (its build {ref_build_s:.1f} s); {wall_s:.1f} s "
        "with the processes' start")
    gr = res["global"]
    log(f"parallel: global graph over {world} process(es) x 2 row blocks "
        f"({res['backend']}), {gr['rows']} rows: search {gr['qps']:.0f} QPS "
        f"== each process's Coordinator ({gr['hops']} hops, {gr['launches']} "
        f"launches in process 0); distributed_build "
        f"{gr['distributed_build_s']:.1f} s == bulk_build, delete 100 "
        f"{gr['delete_100_s']:.2f} s == the Coordinator's; shard-parallel "
        f"save {gr['save_s']:.2f} s ({gr['blocks_written']} blocks by "
        f"process 0), load_global_sharded {gr['load_s']:.2f} s, same answers")
    del single
    _free(torch)
    return {**res, "world_size": world, "rows": mh, "wall_s": wall_s,
            "reference_build_s": ref_build_s,
            "reference_launches": ref_launches}


def multihost_only(n_queries: int) -> int:
    """``--multihost-only``: the multi-process part of the parallel phase
    alone, on the headline corpus' first MULTIHOST_ROWS rows and its
    queries, over every visible card; prints every card's name and power
    limit and the numbers."""
    import torch

    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.kernels import _build
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.utils.corpora import make_corpus

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    _build.build_libraries([k4.LIBRARY])
    p = PATHS["int4_headline"]
    gen, rng = make_corpus(MULTIHOST_ROWS, p["dims"], seed=p["seed"])
    data = gen(MULTIHOST_ROWS)
    queries = data[rng.integers(0, MULTIHOST_ROWS, n_queries)] + 0.01 * (
        rng.standard_normal((n_queries, p["dims"])).astype(np.float32))
    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(p["metric"]), r=64, l_insert=128,
        alpha=1.2, l_search=p["l_search"], dimensions=p["dims"],
        node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.parse(p["edge_type"]),
    )
    cfg.validate()
    res = run_multihost(torch, {"int4": k4}, k4, cfg, data, queries, 10,
                        MULTIHOST_ROWS)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(cards)
    print(json.dumps({"multihost": res}))
    return 0


# --ab-only: each script at its own default size (paper_scale_gist1m at
# --gist-scale-n rows, build batches of GIST_SCALE_BATCH).
AB_INSERT_N = 100_000
AB_ISO_N = 200_000
AB_HARD_N = 100_000
GIST_SCALE_BATCH = 1024


def _ab_step(kernels, kernel, label, fn):
    """``fn()`` with the counters set to 0 just before; ``kernel`` must
    have launched and no other. Returns (fn(), launches)."""
    reset_counts(kernels)
    res = fn()
    return res, check_launches(kernels, kernel, label)


def _held_search(label, row, data, queries, metric, min_recall):
    """A search row's checks: hops reported, every returned distance exact
    to 1e-4, recall@10 >= ``min_recall`` (None: printed only)."""
    hops = row["hops"]
    if not hops or min(np.atleast_1d(hops)) <= 0:
        raise AssertionError(f"{label}: no hops reported ({hops})")
    err = check_exact(label, data, queries[: len(row["ids"])], row["ids"],
                      row["dists"], metric)
    if min_recall is not None and row["recall"] < min_recall:
        raise AssertionError(f"{label}: recall@10 {row['recall']} < "
                             f"{min_recall}")
    return err


def _ab_row(row):
    return {key: v for key, v in row.items()
            if key not in ("ids", "dists", "queries", "data")}


def _ab_hooks(kernels, kernel, script, held):
    """``step`` and ``report`` hooks for a script's own sweep: each build
    and search runs with the counters set to 0 just before and must launch
    ``kernel`` and no other; each row is held by ``held(label, row)`` (its
    largest distance error) and printed with its launches. Also returns
    the launches of each step by label."""
    launches = {}

    def step(label, fn):
        res, launches[label] = _ab_step(kernels, kernel, f"{script} {label}",
                                        fn)
        return res

    def report(label, row):
        row["max_abs_err"] = held(label, row)
        row["launches"] = launches[label]
        print(f"{script} {label} {json.dumps(_ab_row(row))}", flush=True)

    return step, report, launches


def ab_insert_width_card(torch, dev, kernels, k4):
    """``ab_insert_width.sweep`` at its default N: a build at each insert
    width, each searched at each serving width; recall@10 >= 0.95 held."""
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.experiments import ab_insert_width as m
    from duckdb_lm_diskann_tpu_torch.experiments.ab_hard_recall import (
        exact_topk,
    )

    t0 = time.perf_counter()
    data, queries = m.corpus(AB_INSERT_N, min(2048, AB_INSERT_N))
    truth, _ = exact_topk(data, queries, 10, MetricType.L2, dev)
    step, report, launches = _ab_hooks(
        kernels, k4, "ab_insert_width",
        lambda label, row: _held_search(label, row, data, queries, "l2",
                                        0.95))
    rows = m.sweep(data, queries, truth, device=dev,
                   batch=min(1024, len(queries)), step=step, report=report)
    _free(torch)
    log(f"ab_insert_width took {time.perf_counter() - t0:.1f} s")
    return {"n": AB_INSERT_N, "queries": len(queries),
            "rows": [_ab_row(r) for r in rows], "launches": launches,
            "s": time.perf_counter() - t0}


def ab_width_iso_card(torch, dev, kernels, k4):
    """``ab_width_iso.run`` at its default N: W x L on FLOAT32 nodes
    (recall@10 >= 0.95 held), then the INT8-node arm (recall printed;
    distances exact against the rounded vectors the index holds)."""
    from duckdb_lm_diskann_tpu_torch.experiments import ab_width_iso as m

    t0 = time.perf_counter()
    data, queries = m.corpus(AB_ISO_N, m.N_QUERIES)
    truth = m.ground_truth(data, queries, 10, dev)
    stored = {t: m.stored_vectors(data, t) for t in ("float32", "int8")}
    step, report, launches = _ab_hooks(
        kernels, k4, "ab_width_iso",
        lambda label, row: _held_search(
            label, row, stored[row["node_type"]], queries, "l2",
            0.95 if row["node_type"] == "float32" else None))
    res = m.run(data, queries, truth, device=dev, step=step, report=report)
    _free(torch)
    out = {"n": AB_ISO_N, "queries": len(queries), "launches": launches}
    for node_type, arm in res.items():
        out[node_type] = {"build_s": arm["build_s"],
                          "rows": [_ab_row(r) for r in arm["rows"]]}
    out["s"] = time.perf_counter() - t0
    log(f"ab_width_iso took {out['s']:.1f} s")
    return out


def ab_hard_build_card(torch, dev, kernels, k4):
    """``ab_hard_build.sweep`` at its default N: the five build
    configurations, each searched at L = 100, 150, 200 with adaptive
    seeds; HARD's recall is printed, not held."""
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.experiments import ab_hard_build as m
    from duckdb_lm_diskann_tpu_torch.experiments.ab_hard_recall import (
        exact_topk,
    )

    t0 = time.perf_counter()
    data, queries = m.corpus(AB_HARD_N)
    truth, _ = exact_topk(data, queries, 10, MetricType.L2, dev)
    step, report, launches = _ab_hooks(
        kernels, k4, "ab_hard_build",
        lambda label, row: _held_search(label, row, data, queries, "l2",
                                        None))
    res = m.sweep(data, queries, truth, device=dev, step=step, report=report)
    _free(torch)
    out = {"n": AB_HARD_N, "queries": len(queries), "launches": launches}
    for name, row in res.items():
        out[name] = {"build_s": row["build_s"], "refine_s": row["refine_s"],
                     **{f"recall_L{L}": v["recall"]
                        for L, v in row["by_l"].items()},
                     **{f"hops_L{L}": v["hops"]
                        for L, v in row["by_l"].items()}}
    out["s"] = time.perf_counter() - t0
    log(f"ab_hard_build took {out['s']:.1f} s")
    return out


def paper_scale_card(torch, dev, kernels, kt, n):
    """``paper_scale_gist1m`` at ``n`` rows in eight row blocks on the card
    (each holding total / 8, the Coordinator's own tables empty: held by
    the script), recall@10 >= 0.93 and exact distances; then the full
    GIST1M graph (2^20 rows, R = 64) allocated as eight blocks on the card
    (``tests/test_torch_paper_scale.py``'s ``cuda`` twin)."""
    from duckdb_lm_diskann_tpu_torch.experiments import paper_scale_gist1m as m

    t0 = time.perf_counter()
    (gidx, data, rng, res), lb = _ab_step(
        kernels, kt, "paper_scale_gist1m build",
        lambda: m.build(n, GIST_SCALE_BATCH, 32, device=dev))
    found, ls = _ab_step(kernels, kt, "paper_scale_gist1m search",
                         lambda: m.search(gidx, data, rng))
    found["recall"] = found["recall_at_10_l100"]
    res["max_abs_err"] = _held_search("paper_scale_gist1m search", found,
                                      data, found["queries"], "cosine", 0.93)
    res.update(_ab_row(found), launches_build=lb, launches=ls)
    del gidx, data
    _free(torch)
    res["s"] = time.perf_counter() - t0
    print(f"paper_scale_gist1m {json.dumps(res)}", flush=True)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cap = m.capacity(dev)
    m.check_memory_model(cap)
    cap["s"] = time.perf_counter() - t1
    cap["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    _free(torch)
    print(f"paper_scale_gist1m capacity {json.dumps(cap)}", flush=True)
    log(f"paper_scale_gist1m took {time.perf_counter() - t0:.1f} s")
    return {"run": res, "capacity": cap}


def ab_only(gist_scale_n: int) -> int:
    """``--ab-only``: the four index-building A/B scripts on the card, in
    the order ab_insert_width, ab_width_iso, ab_hard_build,
    paper_scale_gist1m; prints their numbers, the card's name and power
    limit, and the ``ok`` line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    from duckdb_lm_diskann_tpu_torch.kernels import _build
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.kernels import int8_frontier as k8
    from duckdb_lm_diskann_tpu_torch.kernels import row_gather as kg
    from duckdb_lm_diskann_tpu_torch.kernels import ternary_frontier as kt

    kernels = {"int4": k4, "ternary": kt, "int8": k8, "row_gather": kg}
    _build.build_libraries([k4.LIBRARY, kt.LIBRARY])
    res = {
        "ab_insert_width": ab_insert_width_card(torch, dev, kernels, k4),
        "ab_width_iso": ab_width_iso_card(torch, dev, kernels, k4),
        "ab_hard_build": ab_hard_build_card(torch, dev, kernels, k4),
        "paper_scale_gist1m": paper_scale_card(torch, dev, kernels, kt,
                                               gist_scale_n),
    }
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "bench", "benchmarks",
                               "duckdb_lm_diskann_tpu")
    )
    if leaked:
        raise AssertionError(f"the A/B scripts imported {leaked}")
    res["s"] = time.perf_counter() - t_start
    log(f"--ab-only took {res['s']:.1f} s")
    print(json.dumps({"ab": res}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def multihost_worker(rank: int, world: int, init: str, wdir: str) -> int:
    """One process of the parallel phase's multi-process run: NCCL on card
    ``rank``, two disjoint shards of the rows it is given there;
    process 0 writes the merged answer and its numbers into ``wdir``."""
    from pathlib import Path

    import torch

    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier
    from duckdb_lm_diskann_tpu_torch.parallel import multihost

    wdir = Path(wdir)
    dev = torch.device("cuda", rank)
    backend = multihost.initialize_distributed(init, world, rank, device=dev)
    if backend != "nccl":
        raise AssertionError(f"backend {backend}")
    p = PATHS["int4_headline"]
    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(p["metric"]), r=64, l_insert=128,
        alpha=1.2, l_search=p["l_search"], dimensions=p["dims"],
        node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.parse(p["edge_type"]),
    )
    cfg.validate()
    rows = np.load(wdir / "rows.npy")
    queries = np.load(wdir / "queries.npy")
    idx = multihost.MultiHostShardedIndex(
        cfg, mesh=multihost.make_global_mesh([dev, dev]))
    int4_frontier.LAUNCHES = 0
    t0 = time.perf_counter()
    idx.build(range(len(rows)), rows, max_batch=2048)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    idx.search(queries[:1024], 10)  # warm-up
    t0 = time.perf_counter()
    ids, dists = idx.search(queries, 10)
    secs = time.perf_counter() - t0
    res = {
        "build_s": build_s, "inserts_per_s": len(rows) / build_s,
        "search_s": secs, "qps": len(queries) / secs,
        "launches": int4_frontier.LAUNCHES, "backend": backend,
    }
    del idx
    res["global"] = multihost_global(torch, dev, cfg, rows, queries, wdir)
    if rank == 0:
        np.save(wdir / "ids.npy", ids)
        np.save(wdir / "dists.npy", dists)
        (wdir / "rank0.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def multihost_global(torch, dev, cfg, rows, queries, wdir):
    """The global graph across the processes of ``--multihost-worker``: row
    blocks two a process on its card, a row reassembled by owner
    contribution plus an NCCL ``all_reduce``, over the first
    MULTIHOST_GLOBAL_ROWS rows. On every process: its search equals the
    process's own ``Coordinator.search`` (ids, distances, hops);
    ``distributed_build`` equals ``bulk_build`` in the blocks it holds, and
    again after the same delete; the shard-parallel save reopens through
    ``load_global_sharded`` with the same answers. Returns its numbers."""
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier
    from duckdb_lm_diskann_tpu_torch.parallel import multihost
    from duckdb_lm_diskann_tpu_torch.parallel.global_graph import (
        GlobalShardedIndex,
        load_global_sharded,
    )

    gmesh = multihost.make_global_mesh([dev, dev])
    n = min(MULTIHOST_GLOBAL_ROWS, len(rows))
    q = queries[:MULTIHOST_GLOBAL_QUERIES]
    one = Coordinator(cfg, device=dev)
    one.bulk_build(range(n), rows[:n], max_batch=2048)
    want = one.search(q, 10)
    hops = one.last_search_stats.hops
    g = GlobalShardedIndex(one, mesh=gmesh)
    g.distribute()
    int4_frontier.LAUNCHES = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = g.search(q, 10)
    search_s = time.perf_counter() - t0
    launches = int4_frontier.LAUNCHES
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and g.last_search_stats.hops == hops):
        raise AssertionError("multihost global: search != the Coordinator's")
    if launches < 2 * hops or launches % 2:
        raise AssertionError(f"multihost global: {launches} launches, {hops} hops")
    del g

    gd = GlobalShardedIndex(Coordinator(cfg, device=dev), mesh=gmesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gd.distributed_build(range(n), rows[:n], max_batch=2048)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    bad = _same_tables(torch, one, gd)
    if bad or gd.coordinator.entry_slot != one.entry_slot:
        raise AssertionError(f"multihost global: build != bulk_build: {bad}")
    victims = np.random.default_rng(0x6D).choice(n, 100, replace=False).tolist()
    t0 = time.perf_counter()
    gd.delete(victims)
    torch.cuda.synchronize(dev)
    delete_s = time.perf_counter() - t0
    one.delete(victims)
    bad = _same_tables(torch, one, gd)
    if bad or gd.coordinator.entry_slot != one.entry_slot:
        raise AssertionError(f"multihost global: tables after delete: {bad}")
    before = gd.search(q, 10)
    t0 = time.perf_counter()
    info = gd.save(wdir / "global_ckpt")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_global_sharded(wdir / "global_ckpt", mesh=gmesh)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    after = back.search(q, 10)
    if not (np.array_equal(before[0], after[0])
            and np.array_equal(before[1], after[1])):
        raise AssertionError("multihost global: the reopened checkpoint differs")
    return {
        "rows": n, "queries": len(q), "search_s": search_s,
        "qps": len(q) / search_s, "hops": hops, "launches": launches,
        "distributed_build_s": build_s, "delete_100_s": delete_s,
        "save_s": save_s, "blocks_written": info["blocks_written"],
        "load_s": load_s,
    }


def refine_hard(torch, dev, kernels, kernel, coord, queries, k, batch):
    """bench.py:183-190: the post-build refine pass (with its reachability
    repair), after one timed lock-step search of the built graph. Returns
    that search's ids and the pass's metrics."""
    ids, _, before = timed_search(
        torch, kernels, kernel, coord, queries, k, "hard before refine",
        batch_size=batch,
    )
    reset_counts(kernels)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rows = coord.refine()
    torch.cuda.synchronize(dev)
    out = {
        "refine_s": time.perf_counter() - t0,
        "rows": rows,
        "relinked": coord.last_relinked,
        "launches": check_launches(kernels, kernel, "hard refine"),
        "search_before": before,
    }
    log(f"hard refine: {rows} rows in {out['refine_s']:.1f} s, "
        f"{out['relinked']} relinked, {out['launches']} launches")
    return ids, out


def run_path(torch, dev, kernels, name, n, n_queries, k=10):
    """Bulk build + search of one main path through the Coordinator on the
    card, then the path's serving options. Returns its metrics; the
    launches are the counts of this path's own runs."""
    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.utils.corpora import (
        make_corpus,
        make_hard_corpus,
    )

    p = PATHS[name]
    dims = p["dims"]
    t0 = time.perf_counter()
    make = make_hard_corpus if p.get("corpus") == "hard" else make_corpus
    gen, rng = make(n, dims, seed=p["seed"])
    data = gen(n)
    qidx = rng.integers(0, n, n_queries)
    queries = data[qidx] + 0.01 * rng.standard_normal(
        (n_queries, dims)
    ).astype(np.float32)
    log(f"{name}: corpus {n} x {dims} made in {time.perf_counter() - t0:.1f} s")
    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(p["metric"]), r=64, l_insert=128,
        alpha=1.2, l_search=p["l_search"], dimensions=dims,
        node_vector_type=VectorType.FLOAT32,
        edge_type=None if p["edge_type"] is None else EdgeType.parse(p["edge_type"]),
    )
    cfg.validate()
    if cfg.resolve_edge_type() is not EdgeType.parse(p["codec"]):
        raise AssertionError(f"{name}: codec {cfg.resolve_edge_type()}")
    kernel = kernels[p["codec"]]

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(kernels)  # count only this path's launches from here
    t0 = time.perf_counter()
    coord = Coordinator(cfg, initial_capacity=n)
    if coord.device.type != "cuda":
        raise AssertionError(f"Coordinator defaulted to {coord.device}")
    coord.bulk_build(range(n), data, max_batch=p["max_batch"])
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    launches_build = kernel.LAUNCHES
    log(f"{name}: built n={n} in {build_s:.1f} s ({n / build_s:.0f} "
        f"inserts/s), {launches_build} kernel launches")
    others = {c: m.LAUNCHES for c, m in kernels.items() if m is not kernel}
    if launches_build <= 0 or any(others.values()):
        raise AssertionError(
            f"{name}: {launches_build} kernel launches in the build, other "
            f"kernels {others}"
        )

    batch = p["search_batch"]
    coord.search(queries[:batch], k)  # warm-up: first-call allocations
    refine = None
    if p.get("refine"):
        ids_unrefined, refine = refine_hard(
            torch, dev, kernels, kernel, coord, queries, k, batch)
    ids, dists, search = timed_search(
        torch, kernels, kernel, coord, queries, k, f"{name} lock-step",
        batch_size=batch,
    )
    reset_counts(kernels)
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        coord.search(queries[i : i + 1], k)
        lat.append(time.perf_counter() - t1)
    launches_b1 = kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)  # before the checks' scans
    log(f"{name}: B=1 median {1e3 * float(np.median(lat)):.2f} ms")

    if ids.shape != (n_queries, k) or dists.shape != (n_queries, k):
        raise AssertionError(f"{name}: result shapes {ids.shape} {dists.shape}")
    if (ids < 0).any():
        raise AssertionError(f"{name}: missing results")
    dist_err = check_exact(name, data, queries, ids, dists, p["metric"])
    truth = exact_topk(torch, dev, data, queries, k, cfg.metric_type)
    recall = recall_of(ids, truth, k)
    log(f"{name}: recall@{k} = {recall:.4f}, max distance error {dist_err:.3g}")
    min_recall = p.get("min_recall", 0.95)
    if min_recall is not None and recall < min_recall:
        raise AssertionError(f"{name}: recall@{k} = {recall} < {min_recall}")
    if refine is not None:
        refine["recall_at_10_before"] = recall_of(ids_unrefined, truth, k)
        refine["recall_at_10_after"] = recall
        log(f"{name}: recall@{k} {refine['recall_at_10_before']:.4f} before "
            f"the refine pass, {recall:.4f} after")
    serving = {}
    if name in SERVE:
        serving = SERVE[name](torch, dev, kernels, kernel, coord, data,
                              queries, ids, truth, k, p["metric"], batch)
    instruments = {}
    if p.get("ab_stream"):
        instruments["ab_stream"] = run_ab_stream(
            torch, kernels, kernel, coord, queries, k, p["l_search"], batch)
    if p.get("ab_hard_recall"):
        instruments["ab_hard_recall"] = run_ab_hard_recall(
            torch, kernels, kernel, coord, data, queries, truth, k)
    lifecycle = None
    if p.get("lifecycle"):
        lifecycle = lifecycle_headline(
            torch, dev, kernels, kernel, coord, data, queries, truth, rng, k,
            p["metric"], batch)
    store = None
    if p.get("store_db"):
        options = {"metric": p["metric"], "r": cfg.r, "l_insert": cfg.l_insert,
                   "alpha": cfg.alpha, "l_search": cfg.l_search,
                   "edge_type": p["edge_type"]}
        store = store_db_headline(
            torch, dev, kernels, kernel, coord, data, queries, truth, rng, k,
            batch, options, keep_dir=bool(p.get("parallel")))
    par = None
    if p.get("parallel"):
        par = parallel_headline(
            torch, dev, kernels, kernel, coord, cfg, data, queries, rng, k,
            batch, store["tmp_dir"])
    if p.get("profile_insert"):  # last: it inserts new rows
        instruments["profile_insert"] = run_profile_insert(
            torch, kernels, kernel, coord, data, p["max_batch"], name)
    del coord
    _free(torch)
    del data, queries
    _free(torch)
    return {
        "n": n,
        "dims": dims,
        "metric": p["metric"],
        "edge_type": p["codec"],
        "corpus": p.get("corpus", "manifold"),
        "build_s": build_s,
        "inserts_per_s": n / build_s,
        "queries": n_queries,
        "search_batch": batch,
        **search,
        "b1_latency_ms_median": 1e3 * float(np.median(lat)),
        "b1_latency_ms_max": 1e3 * float(np.max(lat)),
        "peak_mem_bytes": int(peak),
        "recall_at_10": recall,
        "max_dist_err": dist_err,
        "launches_build": launches_build,
        "launches_search": search["launches"] + launches_b1,
        "launches_serving": sum(m["launches"] for m in serving.values()),
        "serving": serving,
        "launches_refine": refine["launches"] if refine else 0,
        "refine": refine,
        "launches_lifecycle": (
            sum(lifecycle["launches"].values()) if lifecycle else 0),
        "lifecycle": lifecycle,
        "launches_store_db": (
            sum(v for key, v in store["launches"].items() if key != "sql_files")
            if store else 0),
        "store_db": store,
        "launches_parallel": (
            sum(par["launches"].values()) if par else 0),
        "parallel": par,
        "launches_instruments": sum(
            m["launches"] for m in instruments.values()),
        "instruments": instruments,
    }


def build_and_search(torch, dev, kernels, kernel, label, cfg, data, queries,
                     max_batch, batch, min_recall=0.95, k=10):
    """Bulk build + one timed lock-step search of a small configuration
    (after an untimed warm-up batch); the codec's kernel (or none) must be
    the only one to launch. Returns (ids, metrics)."""
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(kernels)
    t0 = time.perf_counter()
    coord = Coordinator(cfg, initial_capacity=len(data))
    coord.bulk_build(range(len(data)), data, max_batch=max_batch)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    launches_build = check_launches(kernels, kernel, f"{label} build")
    coord.search(queries[:batch], k)  # warm-up
    ids, dists, m = timed_search(torch, kernels, kernel, coord, queries, k,
                                 label, batch_size=batch)
    peak = torch.cuda.max_memory_allocated(dev)
    vec = coord.arrays.vectors
    m.update(
        build_s=build_s, inserts_per_s=len(data) / build_s,
        peak_mem_bytes=int(peak), launches_build=launches_build,
        vector_bytes=vec.numel() * vec.element_size(),
        max_dist_err=check_exact(label, data, queries, ids, dists,
                                 cfg.metric_type.value),
        recall_at_10=recall_of(ids, exact_topk(
            torch, dev, data, queries, k, cfg.metric_type), k),
    )
    log(f"{label}: built in {build_s:.1f} s, recall@{k} "
        f"{m['recall_at_10']:.4f}, peak {peak / 2**30:.3f} GiB")
    if min_recall is not None and m["recall_at_10"] < min_recall:
        raise AssertionError(f"{label}: recall@{k} {m['recall_at_10']}")
    del coord
    _free(torch)
    return ids, m


def small_config(metric, edge_type, dims, node_type="float32", l_search=100):
    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig

    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(metric), r=64, l_insert=128, alpha=1.2,
        l_search=l_search, dimensions=dims,
        node_vector_type=VectorType(node_type),
        edge_type=EdgeType.parse(edge_type),
    )
    cfg.validate()
    return cfg


def run_codecs(torch, dev, kernels, n, n_queries):
    """The four codecs without a TPU kernel on DEEP's corpus
    (``make_corpus(n, 96, seed=0xDEE9)``, bench.py:782-788), cosine, R=64,
    L_insert=128, L_search=100, build batches of 2048, search batches of
    1024: FLOAT32, FLOAT16 and NONE must reach recall@10 0.95; FLOAT1BIT's
    navigation is sign-only, so its recall is printed. No kernel launches."""
    from duckdb_lm_diskann_tpu_torch.utils.corpora import make_corpus

    gen, rng = make_corpus(n, 96, seed=0xDEE9)
    data = gen(n)
    queries = data[rng.integers(0, n, n_queries)] + 0.01 * rng.standard_normal(
        (n_queries, 96)).astype(np.float32)
    out = {}
    for codec in ("float32", "float16", "none", "float1bit"):
        _, out[codec] = build_and_search(
            torch, dev, kernels, None, f"codec {codec}",
            small_config("cosine", codec, 96), data, queries, 2048, 1024,
            min_recall=None if codec == "float1bit" else 0.95,
        )
    return {"n": n, "dims": 96, "metric": "cosine", "queries": n_queries,
            "codecs": out}


def run_int8_nodes(torch, dev, kernels, n, n_queries):
    """INT8 node vectors: the headline's corpus scaled and rounded into
    [-128, 127], built with INT8 and with FLOAT32 node vectors, for L2 with
    INT8 edges and for cosine with TERNARY edges. The two builds must
    return identical rowids, and the INT8 vector table must take a quarter
    of the FLOAT32 one's bytes; recall is printed."""
    from duckdb_lm_diskann_tpu_torch.utils.corpora import make_corpus

    gen, rng = make_corpus(n, 128, seed=0xBE7C4)
    data = gen(n)
    data = np.clip(np.round(data * (127.0 / np.abs(data).max())), -128, 127)
    data = data.astype(np.float32)
    queries = data[rng.integers(0, n, n_queries)] + rng.standard_normal(
        (n_queries, 128)).astype(np.float32)
    out = {}
    for metric, codec in (("l2", "int8"), ("cosine", "ternary")):
        runs = {}
        for node in ("int8", "float32"):
            runs[node] = build_and_search(
                torch, dev, kernels, kernels[codec], f"{codec} {node} nodes",
                small_config(metric, codec, 128, node), data, queries, 2048,
                1024, min_recall=None,
            )
        (ids8, m8), (idsf, mf) = runs["int8"], runs["float32"]
        if not np.array_equal(ids8, idsf):
            bad = int((ids8 != idsf).any(-1).sum())
            raise AssertionError(f"{codec}: INT8 nodes != FLOAT32 on {bad}")
        if 4 * m8["vector_bytes"] != mf["vector_bytes"]:
            raise AssertionError(f"{codec}: vector bytes {m8} {mf}")
        out[codec] = {"metric": metric, "int8_nodes": m8,
                      "float32_nodes": mf, "ids_identical": True}
    return {"n": n, "dims": 128, "queries": n_queries, "runs": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 500,000 headline rows (bench.py's 1,000,000 halved) for the run's time:
    # with every other cut below, the run still took 789.7 s on a host that
    # passes 1,200 s ~1.3x slower; the headline's build, store and parallel
    # phases took 128.5 + 109.9 + 154.6 s of it at 1,000,000.
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--hard-n", type=int, default=100_000)
    ap.add_argument("--hard-queries", type=int, default=2048)
    # GIST, INT8 and the INT8 nodes are cut so that the whole run stays near
    # half its 1,200 s on a fast host: at 400,000 / 262,144 / 65,536 rows it
    # took 957.3 s on one and passed 1,200 s on a host ~1.4x slower (GIST's
    # build 109.7 s and 151.7 s; NVIDIA H100 80GB HBM3 at 700 W).
    ap.add_argument("--gist-n", type=int, default=131_072)
    ap.add_argument("--gist-queries", type=int, default=1024)
    ap.add_argument("--int8-n", type=int, default=131_072)
    ap.add_argument("--int8-queries", type=int, default=4096)
    # 32,768: the whole run stays under 850 s (65,536 rows took it to
    # 884 s on a slower H100 host).
    ap.add_argument("--codec-n", type=int, default=32_768)
    ap.add_argument("--codec-queries", type=int, default=4096)
    ap.add_argument("--int8-nodes-n", type=int, default=32_768)
    ap.add_argument("--int8-nodes-queries", type=int, default=4096)
    ap.add_argument("--multihost-only", action="store_true",
                    help="run only the parallel phase's multi-process part "
                         "(on every visible card) and print its numbers")
    ap.add_argument("--multihost-worker", nargs=4, metavar=("RANK", "WORLD", "INIT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--ab-only", action="store_true",
                    help="run only the four index-building A/B scripts of "
                         "experiments/ and print their numbers")
    ap.add_argument("--gist-scale-n", type=int, default=262_144,
                    help="rows of paper_scale_gist1m under --ab-only")
    args = ap.parse_args()
    if args.multihost_worker:
        r, w, init, wdir = args.multihost_worker
        return multihost_worker(int(r), int(w), init, wdir)
    if args.multihost_only:
        return multihost_only(args.queries)
    if args.ab_only:
        return ab_only(args.gist_scale_n)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    from duckdb_lm_diskann_tpu_torch.kernels import _build
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.kernels import int8_frontier as k8
    from duckdb_lm_diskann_tpu_torch.kernels import row_gather as kg
    from duckdb_lm_diskann_tpu_torch.kernels import ternary_frontier as kt

    kernels = {"int4": k4, "ternary": kt, "int8": k8, "row_gather": kg}
    t0 = time.perf_counter()
    _build.build_libraries([m.LIBRARY for m in kernels.values()])
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for m in kernels.values():
        if m.LIBRARY.build_log:
            log(f"nvcc {m.LIBRARY.source.name}: "
                + m.LIBRARY.build_log.strip().replace("\n", "\n[chip_smoke]   "))

    floor = time_ms(torch, lambda i: torch.cuda._sleep(0), 20)
    floor_train = train_ms(torch, lambda i: torch.cuda._sleep(0), 20)
    log(f"timing floor (an empty kernel): {floor:.5f} ms by time_ms, "
        f"{floor_train:.5f} ms by train_ms")
    records = {
        "int4": check_float_scorer(torch, dev, "int4"),
        "ternary": check_ternary(torch, dev),
        "int8": check_float_scorer(torch, dev, "int8"),
    }
    for key, cases in check_ring_cases(torch, dev).items():
        records[key]["ring_cases"] = cases
        records[key]["max_abs_err"] = max(records[key]["max_abs_err"],
                                          cases["max_abs_err"])
    records["gather"], records["gather4"] = check_row_gather(torch, dev)
    profile, hop_instruments, phase3 = run_profiler(torch, dev, kernels)
    records["gather"]["launches"] = phase3["pipelined_gather"]
    records["gather4"]["launches"] = phase3["pipelined_gather4"]
    layout = hop_instruments["ab_int4_layout"] = run_ab_int4_layout(
        torch, dev, kernels)
    t_paths = time.perf_counter()
    metrics = {
        "int4_headline": run_path(torch, dev, kernels, "int4_headline",
                                  args.n, args.queries),
        "hard": run_path(torch, dev, kernels, "hard", args.hard_n,
                         args.hard_queries),
        "gist_ternary": run_path(torch, dev, kernels, "gist_ternary",
                                 args.gist_n, args.gist_queries),
        "int8_l2": run_path(torch, dev, kernels, "int8_l2", args.int8_n,
                            args.int8_queries),
        "codecs": run_codecs(torch, dev, kernels, args.codec_n,
                             args.codec_queries),
        "int8_nodes": run_int8_nodes(torch, dev, kernels, args.int8_nodes_n,
                                     args.int8_nodes_queries),
    }
    log(f"main paths took {time.perf_counter() - t_paths:.1f} s")
    real_card, real_card_launches = run_profile_real_card(torch, dev, kernels)
    hop_instruments["profile_real"].update(real_card)
    records["int4"]["launches"] = (phase3["int4"] + layout["launches"]
                                   + real_card_launches)
    # ab_int4_layout's slope of the shipped kernel, beside #1's own times.
    records["int4"]["ab_int4_layout_slope_ms"] = layout["times"]["kernel"]
    records["ternary"]["launches"] = records["int8"]["launches"] = 0
    for name in ("int4_headline", "hard", "gist_ternary", "int8_l2"):
        path = metrics[name]
        records[path["edge_type"]]["launches"] += sum(
            v for key, v in path.items() if key.startswith("launches_"))
    store = metrics["int4_headline"]["store_db"]
    for codec, count in store["launches"]["sql_files"].items():
        records[codec]["launches"] += count
    for codec, run in metrics["int8_nodes"]["runs"].items():
        for m in (run["int8_nodes"], run["float32_nodes"]):
            records[codec]["launches"] += m["launches_build"] + m["launches"]
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "bench", "benchmarks",
                               "duckdb_lm_diskann_tpu")
    )
    if leaked:
        raise AssertionError(f"the port's main paths imported {leaked}")
    log(f"whole run took {time.perf_counter() - t_start:.1f} s")

    # One record per TPU kernel (#1-#7): a CUDA kernel that replaces two
    # Pallas kernels stands in both rows, with the same numbers.
    rows = []
    for key in ("int4", "ternary", "int8", "gather", "gather4"):
        rec = dict(records[key])
        also = rec.pop("also_replaces", None)
        rows.append(rec)
        if also:
            rows.append({**rec, "name": rec["name"] + "_deep", "replaces": also})
    print(json.dumps({"profile_hop": profile, "timing_floor_ms": floor,
                      "timing_floor_train_ms": floor_train}))
    instruments = dict(hop_instruments)
    for name in ("int4_headline", "hard", "gist_ternary", "int8_l2"):
        for step, rec in metrics[name].pop("instruments").items():
            instruments[f"{name}/{step}"] = rec
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"instruments": instruments}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
