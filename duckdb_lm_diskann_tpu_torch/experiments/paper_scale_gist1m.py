"""GIST1M-class capacity: a 960-d TERNARY global graph in eight row blocks.

The port of ``benchmarks/paper_scale_gist1m.py``. ``run(n, ...)`` builds
the script's own 960-d corpus (rng 0x6157: tanh(z[n, 24] @ w[24, 960] / 5)
+ 0.02 noise) straight into eight row blocks: ``GlobalShardedIndex`` over
``make_mesh([device] * 8)`` and ``distributed_build``, so no device ever
holds more than its blocks and the Coordinator's own tables, allocated at
capacity 8 before the build, stay empty (held). It reports

  * the graph's bytes, in total and in each row block: every block holds
    exactly total / 8 of every non-empty table (held);
  * the build's seconds and rate, and the search's: ``min(512, n)`` noisy
    corpus rows, top-10 at L = 100 over the blocks, with its hops;
  * recall@10 against a brute-force cosine scan on the device.

``capacity(device)`` is the paper-scale memory claim of
``tests/test_paper_scale.py``: the full 2^20-row graph at R = 64 (960-d,
TERNARY) allocated as eight row blocks by ``distributed_build``, ~19.5 kB a row and ~19.5 GB in
all, 1/8 of it in each block. On the ``meta`` device it allocates
nothing and counts the same bytes.

Run alone:

    python -m duckdb_lm_diskann_tpu_torch.experiments.paper_scale_gist1m \\
        [N] [MAX_BATCH] [R] [--device cuda] [--out result.json]

(defaults N = 1,024, MAX_BATCH = 256, R = 32: cosine, TERNARY edges,
L_insert = 2R, L_search = 100). The JSON goes to standard output, and to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.graph import GraphArrays
from ..utils.cuda_timing import synced_s

DIMS = 960
N_BLOCKS = 8


def gist_config(r=32):
    """Cosine, TERNARY edges, FLOAT32 node vectors, 960-d, L_insert 2R,
    L_search 100."""
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig

    cfg = LmDiskannConfig(
        metric_type=MetricType.COSINE, r=r, l_insert=2 * r, l_search=100,
        dimensions=DIMS, node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.TERNARY,
    )
    cfg.validate()
    return cfg


def corpus(n):
    """The script's corpus: (data f32[n, 960], the rng it leaves, which
    draws the query noise next)."""
    rng = np.random.default_rng(0x6157)
    z = rng.standard_normal((n, 24)).astype(np.float32)
    w = (rng.standard_normal((24, DIMS)) / 5).astype(np.float32)
    data = np.tanh(z @ w) + 0.02 * rng.standard_normal((n, DIMS)).astype(
        np.float32)
    return data, rng


def block_bytes(arrays: GraphArrays) -> dict:
    """Bytes of row-sharded ``arrays``: the total over the non-empty
    tables and each block's share. Raises unless every block of every
    non-empty table holds exactly 1/S of it."""
    total, per_block = 0, None
    for name in GraphArrays._fields:
        t = getattr(arrays, name)
        nbytes = t.numel() * t.element_size()
        if not nbytes:
            continue
        blocks = [b.numel() * b.element_size() for b in t.blocks]
        if any(b * len(blocks) != nbytes for b in blocks):
            raise AssertionError(f"{name}: row blocks of {blocks} bytes do "
                                 f"not split its {nbytes} evenly")
        per_block = [p + b for p, b in zip(per_block or [0] * len(blocks),
                                           blocks)]
        total += nbytes
    return {"total": total, "per_block": per_block}


def capacity(device) -> dict:
    """The full GIST1M graph (2^20 rows, R = 64, 960-d TERNARY) allocated
    as ``N_BLOCKS`` row blocks on ``device`` the way a build allocates
    them: ``distributed_build`` of no rows at capacity 2^20 (the ``meta``
    device counts without allocating). Returns ``block_bytes`` and the
    bytes a row."""
    from ..core.coordinator import Coordinator
    from ..parallel.global_graph import GlobalShardedIndex
    from ..parallel.mesh import make_mesh

    rows = 1 << 20
    dev = torch.device(device)
    coord = Coordinator(gist_config(r=64), initial_capacity=8, device=dev)
    gidx = GlobalShardedIndex(coord, mesh=make_mesh([dev] * N_BLOCKS))
    gidx.distributed_build([], np.zeros((0, DIMS), np.float32),
                           capacity=rows)
    res = block_bytes(coord.arrays)
    res["bytes_per_row"] = res["total"] / rows
    return res


def check_memory_model(res) -> None:
    """The memory model of ``tests/test_paper_scale.py`` for ``capacity``:
    vectors 3,840 B + 2 TERNARY planes x 64 edges x 30 words x
    4 B + neighbors 256 B + flags ~= 19.5 kB a row, over 16 GB in all (past
    one 16 GB chip), under 3 GB a block on 8. Raises otherwise."""
    total, blocks = res["total"], res["per_block"]
    if len(blocks) != N_BLOCKS or any(b * N_BLOCKS != total for b in blocks):
        raise AssertionError(f"blocks of {blocks} bytes do not split {total}")
    if not (19_000 <= res["bytes_per_row"] <= 20_000 and total > 16e9
            and total / N_BLOCKS < 3e9):
        raise AssertionError(f"GIST1M graph of {total} bytes, "
                             f"{res['bytes_per_row']} a row")


def build(n, max_batch=256, r=32, *, device):
    """The corpus of ``n`` rows built into ``N_BLOCKS`` row blocks on
    ``device``. Returns (the index, the corpus, its rng, a dict of the
    build's seconds and bytes). Raises if the build wrote the
    Coordinator's own tables or a block holds other than 1/8 of a
    table."""
    from ..core.coordinator import Coordinator
    from ..parallel.global_graph import GlobalShardedIndex
    from ..parallel.mesh import make_mesh

    dev = torch.device(device)
    cfg = gist_config(r=r)
    data, rng = corpus(n)
    coord = Coordinator(cfg, initial_capacity=8, device=dev)
    own = coord.arrays  # the Coordinator's tables before the build
    gidx = GlobalShardedIndex(coord, mesh=make_mesh([dev] * N_BLOCKS))
    _, build_s = synced_s(dev, lambda: gidx.distributed_build(
        range(n), data, max_batch=max_batch))
    if bool(own.valid.any()):
        raise AssertionError("distributed_build wrote the Coordinator's own "
                             "tables")
    sizes = block_bytes(coord.arrays)
    return gidx, data, rng, {
        "n": n, "dims": DIMS, "edge_type": "ternary", "r": cfg.r,
        "max_batch": max_batch, "blocks": N_BLOCKS,
        "build_seconds": build_s, "build_rows_per_s": n / build_s,
        "graph_bytes_total": sizes["total"],
        "graph_bytes_per_block": sizes["per_block"],
    }


def search(gidx, data, rng, *, n_queries=512) -> dict:
    """``min(n_queries, n)`` corpus rows plus 0.01 noise (from ``rng``),
    top-10 at L = 100 over the row blocks: seconds, QPS, hops and
    recall@10 against a brute-force cosine scan on the index's device.
    Also returns the queries and the search's rowids and distances."""
    dev = gidx.coordinator.device
    nq = min(n_queries, len(data))
    q = data[:nq] + 0.01 * rng.standard_normal((nq, DIMS)).astype(np.float32)
    (ids, dists), search_s = synced_s(
        dev, lambda: gidx.search(q, 10, l_search=100))
    base = torch.nn.functional.normalize(torch.as_tensor(data, device=dev),
                                         dim=1)
    qn = torch.nn.functional.normalize(torch.as_tensor(q, device=dev), dim=1)
    truth = torch.topk(qn @ base.T, 10, dim=1).indices.cpu().numpy()
    del base
    hits = sum(len(set(a) & set(b))
               for a, b in zip(ids.tolist(), truth.tolist()))
    return {
        "search_queries": nq, "search_seconds": search_s,
        "search_qps": nq / search_s, "hops": gidx.last_search_stats.hops,
        "recall_at_10_l100": hits / (nq * 10),
        "queries": q, "ids": ids, "dists": dists,
    }


def run(n, max_batch=256, r=32, *, device, n_queries=512) -> dict:
    """``build`` then ``search``: the numbers, with the search's queries,
    rowids and distances and the corpus (``queries``, ``ids``,
    ``dists``, ``data``)."""
    dev = torch.device(device)
    gidx, data, rng, res = build(n, max_batch, r, device=dev)
    res.update(search(gidx, data, rng, n_queries=n_queries))
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else str(dev))
    res["data"] = data
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1024)
    ap.add_argument("max_batch", type=int, nargs="?", default=256)
    ap.add_argument("r", type=int, nargs="?", default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    res = run(args.n, args.max_batch, args.r, device=args.device)
    for key in ("ids", "dists", "queries", "data"):
        del res[key]
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
