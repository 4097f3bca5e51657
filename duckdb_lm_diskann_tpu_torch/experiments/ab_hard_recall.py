"""HARD-corpus recall sweep: what adaptive seeds, L and beam width buy, on
an index already built.

The port of ``benchmarks/ab_hard_recall.py``. ``sweep(coord, queries,
truth_ids, truth_dists)`` searches the queries (``Coordinator.search``,
batches of ``batch_size``) with the baseline options and then each of the
twelve configurations of ``CONFIGS``: adaptive seeds s of a sample of m
nodes at L (s in {2, 4, 8}, m in {4,096, 8,192, 16,384}, L in {100, 150,
200}) and beam width 2. For each it reports strict recall@k against the
exact top-k, eps-recall (the share of returned distances within 1% of the
k-th exact distance), QPS over ``reps`` timed calls after the first, the
first call's seconds ("warm") and the hops of the first call.

Run alone, it builds its own HARD index and its exact top-k on the
device first:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_hard_recall \\
        [N] [--device cuda]

``make_hard_corpus(N, 128, 0x4A2D)`` (default N = 50,000), L2, R = 64,
L_insert = 128, INT4, build batches of 2,048; 1,000 queries near corpus
rows, top-10, 3 reps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

BASELINE = ("baseline", {"l_search": 100})
CONFIGS = tuple(
    (f"adaptive s{s} m{m} L{l}",
     {"l_search": l, "adaptive_seeds": s, "seed_sample": m})
    for s, m, l in (
        (2, 4096, 100), (4, 4096, 100), (8, 4096, 100), (4, 8192, 100),
        (8, 8192, 100), (4, 8192, 150), (8, 8192, 150), (4, 8192, 200),
        (8, 8192, 200), (8, 16384, 150),
    )
) + tuple(
    (f"W2 s8 m8192 L{l}",
     {"l_search": l, "beam_width": 2, "adaptive_seeds": 8,
      "seed_sample": 8192})
    for l in (100, 150)
)


def measure(coord, queries, truth_ids, eps_thr, tag, opts, *, k=10, reps=3,
            batch_size=1024) -> dict:
    """One configuration: the first call's answer and seconds, then QPS
    over ``reps`` more calls."""
    nq = len(queries)
    t0 = time.perf_counter()
    ids, dists = coord.search(queries, k, batch_size=batch_size, **opts)
    warm = time.perf_counter() - t0
    hops = coord.last_search_stats.hops
    t0 = time.perf_counter()
    for _ in range(reps):
        coord.search(queries, k, batch_size=batch_size, **opts)
    qps = nq * reps / (time.perf_counter() - t0) if reps else None
    hit = [len(set(t) & set(r)) / k
           for t, r in zip(truth_ids.tolist(), ids.tolist())]
    return {
        "tag": tag,
        "recall": float(np.mean(hit)),
        "eps1": float((dists <= eps_thr[:, None]).mean()),
        "qps": qps,
        "warm_s": warm,
        "hops": hops,
        **opts,
        "ids": ids,
    }


def sweep(coord, queries, truth_ids, truth_dists, *, k=10, reps=3,
          batch_size=1024, configs=(BASELINE, *CONFIGS), out=print) -> list:
    """``measure`` of each configuration in ``configs`` (the baseline and
    the twelve by default). ``truth_ids`` / ``truth_dists``: the exact
    top-k rowids and distances of each query, [nq, k]. Prints each row as
    one JSON line through ``out`` (without its ids) and returns them."""
    eps_thr = np.asarray(truth_dists)[:, k - 1] * 1.01 + 1e-12
    rows = []
    for tag, opts in configs:
        row = measure(coord, queries, np.asarray(truth_ids), eps_thr, tag,
                      opts, k=k, reps=reps, batch_size=batch_size)
        out(json.dumps({key: v for key, v in row.items() if key != "ids"}))
        rows.append(row)
    return rows


def exact_topk(data, queries, k, metric, device, chunk=1 << 16):
    """Brute-force top-k (rowids, distances) of ``queries`` over ``data``
    on ``device``: the port's ``all_pairs_distance`` in row chunks."""
    from ..ops.distance import all_pairs_distance

    q = torch.as_tensor(queries, device=device)
    best_d = torch.full((len(queries), k), float("inf"), device=device)
    best_i = torch.full((len(queries), k), -1, dtype=torch.int64,
                        device=device)
    for off in range(0, len(data), chunk):
        d = all_pairs_distance(q, torch.as_tensor(data[off : off + chunk],
                                                  device=device), metric)
        dd, ii = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cat_d = torch.cat([best_d, dd], 1)
        cat_i = torch.cat([best_i, ii + off], 1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = cat_i.gather(1, pos)
    return best_i.cpu().numpy(), best_d.cpu().numpy()


def main(argv=None) -> int:
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig
    from ..core.coordinator import Coordinator
    from ..utils.corpora import make_hard_corpus

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=50_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dims, k, nq = args.n, 128, 10, 1000
    gen, rng = make_hard_corpus(n, dims, 0x4A2D)
    data = gen(n)
    queries = data[rng.integers(0, n, nq)] + 0.01 * rng.standard_normal(
        (nq, dims)).astype(np.float32)
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=64, l_insert=128, alpha=1.2,
        l_search=100, dimensions=dims, node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.INT4,
    )
    cfg.validate()
    coord = Coordinator(cfg, initial_capacity=n, device=args.device)
    if coord.device.type == "cuda":
        print(f"{torch.cuda.get_device_name(coord.device)}; torch "
              f"{torch.__version__}", flush=True)
    t0 = time.perf_counter()
    coord.bulk_build(range(n), data, max_batch=2048)
    print(f"# built n={n} in {time.perf_counter() - t0:.1f} s", flush=True)
    truth_ids, truth_dists = exact_topk(data, queries, k, MetricType.L2,
                                        coord.device)
    sweep(coord, queries, truth_ids, truth_dists, k=k,
          out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
