#!/usr/bin/env python3
"""Run the PyTorch port's build -> search main path once on one CUDA card.

Usage, from the repository root:

    python3 chip_smoke.py [--n N] [--queries Q]

Phases (each raises on failure, so the script exits non-zero):

1. Setup: CUDA must be available; TF32 is switched off; the card's name and
   power limit are printed as ``nvidia-smi`` reports them; the INT4
   frontier kernel is built with nvcc from ``duckdb_lm_diskann_tpu_torch/
   csrc`` (into the package's ``_build/``).
2. The kernel against its plain PyTorch version at the headline shapes:
   C = 1,048,576 rows, R = 64, D = 128 (and D = 100 for a ragged word
   count), B = 1024 random current nodes with repeats, for L2/IP/cosine;
   rtol = atol = 1e-5 (the two sum in a different f32 order). Both are
   timed with CUDA events, each call on a fresh set of rows.
3. The main path at real size: ``Coordinator(device="cuda").bulk_build`` of
   the headline corpus (``bench.make_corpus``: N x 128 f32, L2, R=64,
   L_insert=128, alpha=1.2, INT4 edge codes, batches of 2048), then
   ``search`` of the bench queries (top-10 at L_search=100, batches of 1024)
   and B=1 queries. The kernel's launch count must rise during the build
   and during the search; recall@10 against brute force on the card must
   reach 0.95; every returned distance must equal the exact one to 1e-4.

Standard output: a line of end-to-end numbers, the card's name and power
limit, a line with the kernel's numbers, and last
``{"ok": true, "device": {...}}``. Progress goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(dims=128, r=64, l_insert=128, alpha=1.2, l_search=100, k=10)
# The only modules of the JAX package that the port (and this script) may
# load: the jax-free ones it reuses as they are, with their empty packages.
REUSED = frozenset(
    "duckdb_lm_diskann_tpu." + m
    for m in ("common", "common.types", "core", "core.config", "utils",
              "utils.tracing")
)


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


def check_kernel(torch, dev, n_rows=1 << 20, r=64, b=1024, reps=20):
    """Phase 2: kernel vs plain at the headline shapes. Returns the kernel's
    JSON record (without launches)."""
    from duckdb_lm_diskann_tpu.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4

    gen = torch.Generator(device=dev).manual_seed(0x1A4)
    max_err = 0.0
    times = {}
    for d in (128, 100):
        dw = (d + 7) // 8
        codes = torch.randint(
            -(2**31), 2**31, (n_rows, r, dw), dtype=torch.int32, device=dev,
            generator=gen,
        )
        scale = 0.05 * torch.rand((n_rows, r), device=dev, generator=gen)
        scale[:, ::8] = 0.0  # empty edge slots
        queries = 0.3 * torch.randn((b, d), device=dev, generator=gen)
        curs = torch.randint(
            0, n_rows, (reps + 3, b), dtype=torch.int32, device=dev,
            generator=gen,
        )
        curs[:, 1::7] = curs[:, :1]  # repeated rows
        for metric in (MetricType.L2, MetricType.IP, MetricType.COSINE):
            got = k4.int4_frontier_scores(
                curs[0], queries, codes, scale, metric=metric
            )
            want = k4.int4_frontier_scores_plain(
                curs[0], queries, codes, scale, metric=metric
            )
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"kernel output not finite (D={d}, {metric})")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"kernel == plain: D={d} {metric.value} max_abs_err={err:.3g}")
        if d == 128:
            for name, fn in (
                ("ms", k4.int4_frontier_scores),
                ("plain_ms", k4.int4_frontier_scores_plain),
            ):
                times[name] = time_ms(
                    torch,
                    lambda i, fn=fn: fn(
                        curs[i], queries, codes, scale, metric=MetricType.L2
                    ),
                    reps,
                )
            log(f"B={b} R={r} D={d} L2: kernel {times['ms']:.4f} ms, "
                f"plain {times['plain_ms']:.4f} ms")
        del codes, scale, queries, curs
        torch.cuda.empty_cache()
    return {
        "name": "int4_frontier_scores",
        "route": "cuda",
        "source": "duckdb_lm_diskann_tpu_torch/csrc/int4_frontier.cu",
        "replaces": "duckdb_lm_diskann_tpu/experiments/pallas_kernels.py:335",
        "also_replaces": "duckdb_lm_diskann_tpu/experiments/pallas_kernels.py:433",
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
    }


def exact_topk(torch, dev, data, queries, k, chunk=1 << 17):
    """Brute-force top-k by L2 on the card: the port's all_pairs_distance in
    row chunks, then topk."""
    from duckdb_lm_diskann_tpu.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.ops.distance import all_pairs_distance

    q = torch.from_numpy(queries).to(dev)
    best_d = torch.full((len(queries), k), float("inf"), device=dev)
    best_i = torch.full((len(queries), k), -1, dtype=torch.int64, device=dev)
    for off in range(0, len(data), chunk):
        base = torch.from_numpy(data[off : off + chunk]).to(dev)
        d = all_pairs_distance(q, base, MetricType.L2)
        dd, ii = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cat_d = torch.cat([best_d, dd], 1)
        cat_i = torch.cat([best_i, ii + off], 1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = cat_i.gather(1, pos)
    return best_i.cpu().numpy()


def main_path(torch, dev, n, n_queries, max_batch=2048, batch=1024):
    """Phase 3: bulk build + search through the Coordinator on the card."""
    from bench import make_corpus
    from duckdb_lm_diskann_tpu.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4

    h = HEADLINE
    t0 = time.perf_counter()
    gen, rng = make_corpus(n, h["dims"])
    data = gen(n)
    qidx = rng.integers(0, n, n_queries)
    queries = data[qidx] + 0.01 * rng.standard_normal(
        (n_queries, h["dims"])
    ).astype(np.float32)
    log(f"corpus {n} x {h['dims']} made in {time.perf_counter() - t0:.1f} s")
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=h["r"], l_insert=h["l_insert"],
        alpha=h["alpha"], l_search=h["l_search"], dimensions=h["dims"],
        node_vector_type=VectorType.FLOAT32, edge_type=EdgeType.INT4,
    )
    cfg.validate()

    torch.cuda.reset_peak_memory_stats(dev)
    k4.LAUNCHES = 0  # count only the main path's launches from here
    t0 = time.perf_counter()
    coord = Coordinator(cfg, initial_capacity=n, device=dev)
    coord.bulk_build(range(n), data, max_batch=max_batch)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    launches_build = k4.LAUNCHES
    log(f"built n={n} in {build_s:.1f} s ({n / build_s:.0f} inserts/s), "
        f"{launches_build} kernel launches")

    k = h["k"]
    t0 = time.perf_counter()
    ids, dists = coord.search(queries, k, batch_size=batch)
    search_s = time.perf_counter() - t0
    stats = coord.last_search_stats
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        coord.search(queries[i : i + 1], k)
        lat.append(time.perf_counter() - t1)
    launches_search = k4.LAUNCHES - launches_build
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"searched {n_queries} queries in {search_s:.2f} s "
        f"({n_queries / search_s:.0f} QPS at batch {batch}), "
        f"{launches_search} kernel launches; B=1 median "
        f"{1e3 * float(np.median(lat)):.2f} ms")
    if launches_build <= 0 or launches_search <= 0:
        raise AssertionError(
            f"kernel not on the main path: {launches_build} launches in the "
            f"build, {launches_search} in the search"
        )

    if ids.shape != (n_queries, k) or dists.shape != (n_queries, k):
        raise AssertionError(f"result shapes {ids.shape} {dists.shape}")
    if (ids < 0).any() or not np.isfinite(dists).all():
        raise AssertionError("missing or non-finite results")
    exact = np.sqrt(
        ((queries[:, None, :].astype(np.float64) - data[ids]) ** 2).sum(-1)
    )
    dist_err = float(np.abs(dists - exact).max())
    if dist_err > 1e-4:
        raise AssertionError(f"returned distances off by {dist_err}")
    truth = exact_topk(torch, dev, data, queries, k)
    recall = float(np.mean([
        len(set(a) & set(b)) / k for a, b in zip(ids.tolist(), truth.tolist())
    ]))
    log(f"recall@{k} = {recall:.4f}, max distance error {dist_err:.3g}")
    if recall < 0.95:
        raise AssertionError(f"recall@{k} = {recall} < 0.95")
    return {
        "n": n,
        "dims": h["dims"],
        "build_s": build_s,
        "inserts_per_s": n / build_s,
        "queries": n_queries,
        "search_s": search_s,
        "qps_batch1024": n_queries / search_s,
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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier as k4

    t0 = time.perf_counter()
    k4.load_library()
    log(f"kernel built and loaded in {time.perf_counter() - t0:.1f} s")
    if k4.BUILD_LOG:
        log("nvcc: " + k4.BUILD_LOG.strip().replace("\n", "\n[chip_smoke] nvcc: "))

    kernel = check_kernel(torch, dev)
    metrics = main_path(torch, dev, args.n, args.queries)
    kernel = {**kernel, "launches": metrics["launches_build"]
              + metrics["launches_search"]}
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib")
        or (m.startswith("duckdb_lm_diskann_tpu.") and m not in REUSED)
    )
    if leaked:
        raise AssertionError(f"the port's main path imported {leaked}")

    print(json.dumps({"metrics": metrics}))
    print(card)
    print(json.dumps({"kernels": [kernel]}))
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
