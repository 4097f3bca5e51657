#!/usr/bin/env python3
"""Run the PyTorch port's build -> search main paths once on one CUDA card.

Usage, from the repository root:

    python3 chip_smoke.py [--n N] [--queries Q] [--gist-n N] [--int8-n N]

Phases (each raises on failure, so the script exits non-zero):

1. Setup: CUDA must be available; TF32 is switched off; the card's name and
   power limit are read from ``nvidia-smi``; the three frontier kernels
   (INT4, TERNARY, INT8) are built from ``duckdb_lm_diskann_tpu_torch/csrc``
   with one nvcc each, all started together (into the package's
   ``_build/``).
2. Each kernel against its plain PyTorch version at its main path's shapes,
   over 1,048,576 rows, R = 64, B = 1024 random current nodes with repeats:
   INT4 at D = 128 and 100 and INT8 at D = 128 and 100, for L2/IP/cosine,
   rtol = atol = 1e-5 (the two sum in a different f32 order); TERNARY at
   W = 30 (D = 960) and W = 4, exactly equal (integer scores). Each is timed
   with CUDA events, every call on a fresh set of rows, beside the least
   time the card could take for the same work (``bound_ms``).
3. The main paths through ``Coordinator`` (on the card by default):
   ``bulk_build``, then ``search`` in batches, then 20 B=1 queries:
   - INT4 headline: ``make_corpus(N, 128)``, L2, R=64, L_insert=128,
     alpha=1.2, INT4 edges, build batches of 2048; top-10 at L_search=100,
     search batches of 1024 (``--n``, default 1,000,000);
   - GIST: ``make_corpus(N, 960, seed=0x61577)``, cosine, default codec
     (TERNARY), R=64, L_insert=128, build batches of 1024; 1024 queries,
     top-10 at L_search=128, search batches of 256 (``--gist-n``, default
     1,000,000);
   - INT8: ``make_corpus(N, 128)``, L2, default codec (INT8), R=64,
     L_insert=128, build batches of 2048; top-10 at L_search=100, search
     batches of 1024 (``--int8-n``, default 1,000,000).
   Every kernel counter is set to 0 just before a path and read just
   after; the path's kernel must have launched in its build and in its
   search. recall@10 against a brute-force scan on the card must reach
   0.95, and every returned distance must equal the exact f64 one to 1e-4.
   Each path's tensors are freed before the next.

Standard output: a line of end-to-end numbers per path, the card's name and
power limit, a line with the kernels' numbers, and last
``{"ok": true, "device": {...}}``. Progress goes to standard error.
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


def time_ms(torch, fn, n_calls: int) -> float:
    """Median over ``n_calls`` calls of the time between CUDA events around
    each call, after a warm-up; fn(i) gets the call index."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    events = []
    for i in range(n_calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(3 + i)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


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
                -127, 128, (n_rows, r, d), dtype=torch.int8, device=dev,
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
            rec["bound_ms"], rec["bound_by"] = bound(
                curs, reps, row_bytes=row_bytes,
                fixed_bytes=b * (4 * d + 4 + 4 * r), ops=4 * b * r * d,
            )
            log(f"{codec} B={b} R={r} D={d} L2: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")
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
            rec["bound_ms"], rec["bound_by"] = bound(
                curs, reps, row_bytes=r * w * 4 * 2,
                fixed_bytes=b * (4 * 2 * w + 4 + 4 * r), ops=12 * b * r * w,
            )
            log(f"ternary B={b} R={r} W={w}: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")
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


def exact_topk(torch, dev, data, queries, k, metric, chunk=1 << 17):
    """Brute-force top-k on the card: the port's all_pairs_distance in row
    chunks, then topk."""
    from duckdb_lm_diskann_tpu_torch.ops.distance import all_pairs_distance

    q = torch.from_numpy(queries).to(dev)
    best_d = torch.full((len(queries), k), float("inf"), device=dev)
    best_i = torch.full((len(queries), k), -1, dtype=torch.int64, device=dev)
    for off in range(0, len(data), chunk):
        base = torch.from_numpy(data[off : off + chunk]).to(dev)
        d = all_pairs_distance(q, base, metric)
        dd, ii = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cat_d = torch.cat([best_d, dd], 1)
        cat_i = torch.cat([best_i, ii + off], 1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = cat_i.gather(1, pos)
    return best_i.cpu().numpy()


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
        max_batch=2048, search_batch=1024, codec="int4",
    ),
    "gist_ternary": dict(
        dims=960, seed=0x61577, metric="cosine", edge_type=None,
        l_search=128, max_batch=1024, search_batch=256, codec="ternary",
    ),
    "int8_l2": dict(
        dims=128, seed=0xBE7C4, metric="l2", edge_type=None, l_search=100,
        max_batch=2048, search_batch=1024, codec="int8",
    ),
}


def run_path(torch, dev, kernels, name, n, n_queries, k=10):
    """Bulk build + search of one main path through the Coordinator on the
    card. Returns its metrics; the launches are the counts of this path's
    run alone."""
    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.utils.corpora import make_corpus

    p = PATHS[name]
    dims = p["dims"]
    t0 = time.perf_counter()
    gen, rng = make_corpus(n, dims, seed=p["seed"])
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
    for mod in kernels.values():
        mod.LAUNCHES = 0  # count only this path's launches from here
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

    batch = p["search_batch"]
    t0 = time.perf_counter()
    ids, dists = coord.search(queries, k, batch_size=batch)
    search_s = time.perf_counter() - t0
    stats = coord.last_search_stats
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        coord.search(queries[i : i + 1], k)
        lat.append(time.perf_counter() - t1)
    launches_search = kernel.LAUNCHES - launches_build
    others = {c: m.LAUNCHES for c, m in kernels.items() if m is not kernel}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{name}: searched {n_queries} queries in {search_s:.2f} s "
        f"({n_queries / search_s:.0f} QPS at batch {batch}), "
        f"{launches_search} kernel launches; B=1 median "
        f"{1e3 * float(np.median(lat)):.2f} ms; other kernels {others}")
    if launches_build <= 0 or launches_search <= 0:
        raise AssertionError(
            f"{name}: kernel not on the main path: {launches_build} launches "
            f"in the build, {launches_search} in the search"
        )
    if any(others.values()):
        raise AssertionError(f"{name}: other codecs' kernels ran: {others}")
    del coord
    _free(torch)

    if ids.shape != (n_queries, k) or dists.shape != (n_queries, k):
        raise AssertionError(f"{name}: result shapes {ids.shape} {dists.shape}")
    if (ids < 0).any() or not np.isfinite(dists).all():
        raise AssertionError(f"{name}: missing or non-finite results")
    exact = exact_distances(queries, data[ids], p["metric"])
    dist_err = float(np.abs(dists - exact).max())
    if dist_err > 1e-4:
        raise AssertionError(f"{name}: returned distances off by {dist_err}")
    truth = exact_topk(torch, dev, data, queries, k, cfg.metric_type)
    recall = float(np.mean([
        len(set(a) & set(b)) / k for a, b in zip(ids.tolist(), truth.tolist())
    ]))
    log(f"{name}: recall@{k} = {recall:.4f}, max distance error {dist_err:.3g}")
    if recall < 0.95:
        raise AssertionError(f"{name}: recall@{k} = {recall} < 0.95")
    del data, queries
    _free(torch)
    return {
        "n": n,
        "dims": dims,
        "metric": p["metric"],
        "edge_type": p["codec"],
        "build_s": build_s,
        "inserts_per_s": n / build_s,
        "queries": n_queries,
        "search_batch": batch,
        "search_s": search_s,
        "qps": n_queries / search_s,
        "hops": stats.hops,
        "mean_visits_per_query": stats.mean_visits_per_query,
        "b1_latency_ms_median": 1e3 * float(np.median(lat)),
        "b1_latency_ms_max": 1e3 * float(np.max(lat)),
        "peak_mem_bytes": int(peak),
        "recall_at_10": recall,
        "max_dist_err": dist_err,
        "launches_build": launches_build,
        "launches_search": launches_search,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--gist-n", type=int, default=1_000_000)
    ap.add_argument("--gist-queries", type=int, default=1024)
    ap.add_argument("--int8-n", type=int, default=1_000_000)
    ap.add_argument("--int8-queries", type=int, default=4096)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    from duckdb_lm_diskann_tpu_torch.kernels import _build
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4
    from duckdb_lm_diskann_tpu_torch.kernels import int8_frontier as k8
    from duckdb_lm_diskann_tpu_torch.kernels import ternary_frontier as kt

    kernels = {"int4": k4, "ternary": kt, "int8": k8}
    t0 = time.perf_counter()
    _build.build_libraries([m.LIBRARY for m in kernels.values()])
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for m in kernels.values():
        if m.LIBRARY.build_log:
            log(f"nvcc {m.LIBRARY.source.name}: "
                + m.LIBRARY.build_log.strip().replace("\n", "\n[chip_smoke]   "))

    records = {
        "int4": check_float_scorer(torch, dev, "int4"),
        "ternary": check_ternary(torch, dev),
        "int8": check_float_scorer(torch, dev, "int8"),
    }
    t_paths = time.perf_counter()
    metrics = {
        "int4_headline": run_path(torch, dev, kernels, "int4_headline",
                                  args.n, args.queries),
        "gist_ternary": run_path(torch, dev, kernels, "gist_ternary",
                                 args.gist_n, args.gist_queries),
        "int8_l2": run_path(torch, dev, kernels, "int8_l2", args.int8_n,
                            args.int8_queries),
    }
    log(f"main paths took {time.perf_counter() - t_paths:.1f} s")
    for path in metrics.values():
        rec = records[path["edge_type"]]
        rec["launches"] = path["launches_build"] + path["launches_search"]
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "bench", "duckdb_lm_diskann_tpu")
    )
    if leaked:
        raise AssertionError(f"the port's main paths imported {leaked}")

    print(json.dumps({"metrics": metrics}))
    print(card)
    print(json.dumps({"kernels": [records[c] for c in ("int4", "ternary", "int8")]}))
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
