"""Serving beam width x L grid at equal recall, and INT8 node vectors.

The port of ``benchmarks/ab_width_iso.py``. A beam width W > 1 visits W
nodes a hop, so a search takes about 1/W of the hops at ~W times the
frontier work a hop. The grid asks whether (W = 2, L = 50) beats (W = 1,
L = 100) at equal recall: ``serve(coord, queries, truth, width, L)`` runs
``searcher.beam_search_many`` over the queries in batches of ``batch``
with ``assume_all_valid=True``, one warm call, then the best of ``reps``
timed calls; recall@k comes from the warm call's answer, against the
strict ``argpartition`` top-k of ``ground_truth``.

The INT8 arm (``run``'s second build) stores the same float
corpus as INT8 node vectors. The builder stores an INT8 node vector by
rounding and clipping into [-128, 127], with no scale, as the JAX builder
does: ``make_corpus(200_000, 128)`` has |x| <= 4.68 and std 0.87, so the
stored vectors keep 10 integer levels and 43.6% of their components are
0, and its recall collapses. Its recall is printed, not held; its
returned distances are exact against the rounded vectors the index holds
(``stored_vectors``).

Run alone, it builds its own indexes:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_width_iso \\
        [N] [--device cuda]

``make_corpus(N, 128)`` (default N = 200,000), 4,096 queries near corpus
rows, L2, R = 64, L_insert = 128, alpha = 1.2, INT4 edges, build batches
of 2,048; W in {1, 2, 4} x L in {50, 75, 100} on FLOAT32 node vectors,
then INT8 node vectors at W = 1, L in {50, 100}; top-10 in 4 batches of
1,024.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.searcher import beam_search_many
from .ab_hard_recall import recall, rowids_of
from .ab_insert_width import build, corpus, print_row, run_step, summary

WIDTHS = (1, 2, 4)
LS = (50, 75, 100)
INT8_LS = (50, 100)
MAX_BATCH = 2048
N_QUERIES = 4096


def ground_truth(data, queries, k, device, chunk=512) -> np.ndarray:
    """The script's strict ground truth: L2 ``all_pairs_distance`` of
    ``chunk`` queries at a time on ``device``, then ``np.argpartition`` on
    the host: the k nearest rowids of each query, in no order."""
    from ..common.types import MetricType
    from ..ops.distance import all_pairs_distance

    base = torch.as_tensor(data, device=device)
    out = []
    for s in range(0, len(queries), chunk):
        d = all_pairs_distance(
            torch.as_tensor(queries[s : s + chunk], device=device), base,
            MetricType.L2).cpu().numpy()
        out.append(np.argpartition(d, k, axis=1)[:, :k])
    return np.concatenate(out)


def stored_vectors(data, node_type) -> np.ndarray:
    """The vectors an index of ``node_type`` holds for ``data``: INT8 node
    vectors are rounded half to even and clipped into [-128, 127]."""
    if node_type == "int8":
        return np.clip(np.round(data), -128, 127).astype(np.float32)
    return data


def serve(coord, queries, truth_ids, width, l_search, *, k=10, batch=1024,
          reps=3) -> dict:
    """``beam_search_many`` of ``queries`` (whole batches of ``batch``) at
    beam width ``width`` and ``l_search``: QPS of the best of ``reps``
    timed calls after one warm call, recall@k of the warm call's answer
    against ``truth_ids``, each batch's hops, and the warm call's rowids
    and distances."""
    nq, dims = queries.shape
    if nq % batch:
        raise ValueError(f"{nq} queries are not whole batches of {batch}")
    qs = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                         device=coord.device).reshape(nq // batch, batch, dims)

    def call():
        return beam_search_many(
            coord.arrays, qs, coord.entry_slot, params=coord.params,
            l_search=l_search, k=k, beam_width=width, assume_all_valid=True,
        )

    res = call()
    res.topk_dists[:1, :1, :1].cpu()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call().topk_dists[:1, :1, :1].cpu()
        best = min(best, time.perf_counter() - t0)
    ids = rowids_of(coord, res.topk_slots.reshape(nq, k).cpu().numpy())
    return {
        "width": width,
        "l_search": l_search,
        "qps": nq / best,
        "recall": recall(ids, truth_ids, k),
        "hops": res.hops.cpu().tolist(),
        "ids": ids,
        "dists": res.topk_dists.reshape(nq, k).cpu().numpy(),
    }


def run(data, queries, truth_ids, *, device, batch=1024, step=run_step,
        report=print_row) -> dict:
    """The W x L grid on a FLOAT32-node build, then W = 1 at ``INT8_LS``
    on an INT8-node build of the same corpus, in batches of ``batch``.
    Each build and each search runs through ``step(label, fn)``, each row
    goes to ``report(label, row)``. Returns {node type: {build_s, rows}},
    the rows with their ids and distances."""
    from ..common.types import VectorType

    res = {}
    for node_type, grid in (("float32", [(w, L) for w in WIDTHS for L in LS]),
                            ("int8", [(1, L) for L in INT8_LS])):
        coord, secs, _ = step(f"build {node_type}", lambda: build(
            data, device=device, max_batch=MAX_BATCH,
            node_vector_type=VectorType(node_type)))
        rows = []
        for width, L in grid:
            label = f"{node_type} W={width} L={L}"
            row = {"node_type": node_type,
                   **step(label, lambda: serve(coord, queries, truth_ids,
                                               width, L, batch=batch))}
            report(label, row)
            rows.append(row)
        res[node_type] = {"build_s": secs, "rows": rows}
        del coord
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    data, queries = corpus(args.n, N_QUERIES)
    truth = ground_truth(data, queries, 10, dev)
    res = run(data, queries, truth, device=dev,
              batch=min(1024, len(queries)))
    print(json.dumps({"ab_width_iso": {
        node_type: {"build_s": arm["build_s"],
                    "rows": [summary(r) for r in arm["rows"]]}
        for node_type, arm in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
