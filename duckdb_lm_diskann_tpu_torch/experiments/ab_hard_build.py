"""HARD corpus: what build options do for strict recall.

The port of ``benchmarks/ab_hard_build.py``. The search options are spent
on HARD (``ab_hard_recall``: adaptive seeds and L reach 0.988 at L = 200,
never 0.99), so this sweep varies the build: the post-build refine pass
(the Vamana second pass and its reachability repair), a wider graph (R =
96, L_insert = 192) and alpha 1.3. Each configuration of ``CONFIGS`` is
built fresh (``ab_insert_width.build``), refined where it says so (timed),
and searched (``search``) at L in {100, 150, 200} with the shipped adaptive
seeding (2 seeds of a 4,096-node sample, ``Coordinator.search`` batches of
1,000): strict recall@10 against the exact top-10, and the hops.

The exact top-10 is ``ab_hard_recall.exact_topk``, on the device in one
pass (the JAX script merged chunked ``argpartition``s on the host: the
same answer).

Run alone, it builds its own indexes:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_hard_build \\
        [N] [CONFIGS] [--device cuda]

``make_hard_corpus(N, 128, 0x4A2D)`` (default N = 100,000), 1,000 queries
near corpus rows, L2, INT4 edges, FLOAT32 node vectors, build batches of
2,048; ``CONFIGS`` a comma list of base, refine, r96, r96refine,
a13refine (default all five).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .ab_hard_recall import exact_topk, recall
from .ab_insert_width import build, print_row, run_step

# name: (R, L_insert, alpha, refine after the build)
CONFIGS = {
    "base": (64, 128, 1.2, False),
    "refine": (64, 128, 1.2, True),
    "r96": (96, 192, 1.2, False),
    "r96refine": (96, 192, 1.2, True),
    "a13refine": (64, 128, 1.3, True),
}
LS = (100, 150, 200)
SEARCH_OPTS = {"adaptive_seeds": 2, "seed_sample": 4096, "batch_size": 1000}


def search(coord, queries, truth_ids, l_search, *, k=10) -> dict:
    """``coord.search`` of ``queries`` at ``l_search`` with
    ``SEARCH_OPTS``: recall@k against ``truth_ids``, hops, rowids and
    distances."""
    ids, dists = coord.search(queries, k, l_search=l_search, **SEARCH_OPTS)
    return {"recall": recall(ids, truth_ids, k),
            "hops": coord.last_search_stats.hops, "ids": ids, "dists": dists}


def sweep(data, queries, truth_ids, *, device, configs=CONFIGS, which=None,
          ls=LS, k=10, max_batch=2048, step=run_step,
          report=print_row) -> dict:
    """Each configuration named in ``which`` (default all of ``configs``)
    built fresh (refined where it says so), then ``search``ed at each L.
    Each build and each search runs through ``step(label, fn)``, each
    search's row goes to ``report(label, row)``. Returns {name: {build_s,
    refine_s, by_l: {L: row}}}, the rows with their ids and distances."""
    res = {}
    for name in which or list(configs):
        r, l_insert, alpha, do_refine = configs[name]
        coord, build_s, refine_s = step(f"{name} build", lambda: build(
            data, device=device, max_batch=max_batch, refine=do_refine,
            r=r, l_insert=l_insert, alpha=alpha))
        by_l = {}
        for L in ls:
            label = f"{name} L={L}"
            by_l[L] = step(label, lambda: search(coord, queries, truth_ids,
                                                 L, k=k))
            report(label, {"config": name, "build_s": build_s,
                           "refine_s": refine_s, "l_search": L, **by_l[L]})
        res[name] = {"build_s": build_s, "refine_s": refine_s, "by_l": by_l}
        del coord
    return res


def corpus(n, nq=1000, dims=128):
    """``make_hard_corpus(n, dims, 0x4A2D)`` and ``nq`` queries: corpus
    rows plus 0.01 noise, from the corpus' rng in the script's order."""
    from ..utils.corpora import make_hard_corpus

    gen, rng = make_hard_corpus(n, dims, 0x4A2D)
    data = gen(n)
    qidx = rng.integers(0, n, nq)
    queries = data[qidx] + 0.01 * rng.standard_normal((nq, dims)).astype(
        np.float32)
    return data, queries


def main(argv=None) -> int:
    from ..common.types import MetricType

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("configs", nargs="?", default=",".join(CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    which = args.configs.split(",")
    unknown = sorted(set(which) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configurations {unknown}; choose from {list(CONFIGS)}")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    data, queries = corpus(args.n)
    truth, _ = exact_topk(data, queries, 10, MetricType.L2, dev)
    res = sweep(data, queries, truth, device=dev, which=which)
    print(json.dumps({name: {
        "build_s": row["build_s"], "refine_s": row["refine_s"],
        **{f"recall_L{L}": v["recall"] for L, v in row["by_l"].items()},
    } for name, row in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
