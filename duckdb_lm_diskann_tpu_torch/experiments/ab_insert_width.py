"""A/B: the insert path's beam width against the serving beam width.

The port of ``benchmarks/ab_insert_width.py``. For each insert beam width
(``config.insert_beam_width``, ``INSERT_WIDTHS``) ``build`` bulk-builds
the corpus into a fresh index and ``sweep`` reports the build's wall
seconds and its steady insert rate (``steady_rate``); ``serve`` then
searches the built graph at each serving beam width (``SERVE_WIDTHS``)
through ``searcher.beam_search`` with ``assume_all_valid=True`` (a fresh
build has no tombstones), in batches of ``batch``: one warm call, then the
best QPS of ``reps`` timed passes over every batch, recall@k against the
exact top-k and the hops of each batch.

``build``, ``run_step`` and ``print_row`` serve ``ab_width_iso`` and
``ab_hard_build`` too: one build with options, and the hooks through
which a caller checks each build and search of a sweep.

The steady insert rate is the rows of the build's batches after the first
over their summed seconds, read from the build's ``insert.step`` spans
(``utils/tracing.py``; ``sweep`` builds with the recorder on): the first
batch pays the kernel's load and the card's warm-up. (The JAX script
counted any batch over 1 s as compile time; the port compiles nothing.)

Run alone, it builds its own indexes:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_insert_width \\
        [N] [--device cuda]

``make_corpus(N, 128)`` (default N = 100,000), L2, R = 64, L_insert = 128,
alpha = 1.2, INT4 edges, FLOAT32 node vectors, build batches of 1,024;
min(2,048, N) queries near corpus rows, top-10 at L = 100, batches of
min(1,024, queries).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.searcher import beam_search
from ..utils import tracing
from ..utils.cuda_timing import synced_s
from .ab_hard_recall import exact_topk, recall, rowids_of

INSERT_WIDTHS = (1, 2, 4)
SERVE_WIDTHS = (1, 2, 4)
# The A/B builds' configuration; ``build`` takes overrides of any field.
BASE_CONFIG = {"r": 64, "l_insert": 128, "alpha": 1.2, "l_search": 100}


def build(data, *, device, max_batch=1024, refine=False, **overrides):
    """A fresh index of ``data`` (rowids 0..n-1): L2, ``BASE_CONFIG``,
    INT4 edges and FLOAT32 node vectors, each ``LmDiskannConfig`` field
    overridden by ``overrides``, bulk-built in batches of ``max_batch``,
    then refined when ``refine``. Returns (coord, build s, refine s): host
    clock, the card's queue drained."""
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig
    from ..core.coordinator import Coordinator

    n, dims = data.shape
    cfg = LmDiskannConfig(**{
        "metric_type": MetricType.L2, "dimensions": dims,
        "node_vector_type": VectorType.FLOAT32, "edge_type": EdgeType.INT4,
        **BASE_CONFIG, **overrides,
    })
    cfg.validate()
    coord = Coordinator(cfg, initial_capacity=n, device=device)
    _, build_s = synced_s(coord.device, lambda: coord.bulk_build(
        range(n), data, max_batch=max_batch))
    refine_s = synced_s(coord.device, coord.refine)[1] if refine else 0.0
    return coord, build_s, refine_s


def steady_rate(spans):
    """Rows a second over the batches after the first of the last
    ``insert`` call in ``spans`` (``tracing.spans()`` of a build made with
    the recorder on): its ``insert.step`` spans' rows over their summed
    seconds. None for a one-batch build."""
    roots = [s for s in spans if s.parent is None and s.name == "insert"]
    if not roots:
        return None
    steady = [s for s in spans
              if s.call == roots[-1].call and s.name == "insert.step"][1:]
    if not steady:
        return None
    return (sum(s.attrs["rows"] for s in steady)
            / sum(s.t1 - s.t0 for s in steady))


def run_step(label, fn):
    """The sweeps' default ``step``: ``fn()``. A caller's ``step`` may
    wrap each build and search (``label`` names it) in checks."""
    return fn()


def summary(row) -> dict:
    """``row`` without its rowids and distances."""
    return {key: v for key, v in row.items() if key not in ("ids", "dists")}


def print_row(label, row) -> None:
    """The sweeps' default ``report``: ``label`` and ``summary(row)``."""
    print(label, json.dumps(summary(row)), flush=True)


def serve(coord, queries, truth_ids, width, *, k=10, l_search=100,
          batch=1024, reps=3) -> dict:
    """``beam_search`` of ``queries`` in batches of ``batch`` at serving
    beam width ``width``: the best QPS of ``reps`` timed passes after one
    warm call, recall@k against ``truth_ids`` and each batch's hops.
    Returns those with the rowids and distances of the last pass."""
    nq = len(queries)
    nb = nq // batch
    if nb == 0:
        raise ValueError(f"{nq} queries hold no batch of {batch}")
    q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                        device=coord.device)

    def run(i):
        return beam_search(
            coord.arrays, q[i * batch : (i + 1) * batch], coord.entry_slot,
            params=coord.params, l_search=l_search, k=k, beam_width=width,
            assume_all_valid=True,
        )

    run(0).topk_dists[:1, :1].cpu()  # the warm call, read back
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [run(i) for i in range(nb)]
        outs[-1].topk_dists[:1, :1].cpu()
        best = max(best, nb * batch / (time.perf_counter() - t0))
    slots = torch.cat([o.topk_slots for o in outs]).cpu().numpy()
    ids = rowids_of(coord, slots)
    return {
        "serve_width": width,
        "qps": best,
        "recall": recall(ids, truth_ids[: nb * batch], k),
        "hops": [int(o.hops) for o in outs],
        "ids": ids,
        "dists": torch.cat([o.topk_dists for o in outs]).cpu().numpy(),
    }


def sweep(data, queries, truth_ids, *, device, batch=1024, step=run_step,
          report=print_row) -> list:
    """``build`` at each insert width, then ``serve`` at each serving width
    in batches of ``batch``. Each build and each search runs through
    ``step(label, fn)``, each row goes to ``report(label, row)``. Returns
    the rows, with their ids and distances."""
    rows = []
    for w_ins in INSERT_WIDTHS:
        tracing.clear()
        tracing.enable()
        try:
            coord, build_s, _ = step(f"build W_insert={w_ins}", lambda: build(
                data, device=device, insert_beam_width=w_ins))
        finally:
            tracing.disable()
        rate = steady_rate(tracing.spans())
        for w_srv in SERVE_WIDTHS:
            label = f"W_insert={w_ins} W_serve={w_srv}"
            row = {"insert_width": w_ins, "build_s": build_s,
                   "steady_inserts_per_s": rate,
                   **step(label, lambda: serve(coord, queries, truth_ids,
                                               w_srv, batch=batch))}
            report(label, row)
            rows.append(row)
        del coord
    return rows


def corpus(n, nq, dims=128):
    """``make_corpus(n, dims)`` and ``nq`` queries: corpus rows plus 0.01
    noise, drawn from the corpus' rng in the script's order."""
    from ..utils.corpora import make_corpus

    gen, rng = make_corpus(n, dims)
    data = gen(n)
    qidx = rng.integers(0, n, nq)
    queries = data[qidx] + 0.01 * rng.standard_normal((nq, dims)).astype(
        np.float32)
    return data, queries


def main(argv=None) -> int:
    from ..common.types import MetricType

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    data, queries = corpus(args.n, min(2048, args.n))
    truth, _ = exact_topk(data, queries, 10, MetricType.L2, dev)
    rows = sweep(data, queries, truth, device=dev,
                 batch=min(1024, len(queries)))
    print(json.dumps({"ab_insert_width": [summary(r) for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
