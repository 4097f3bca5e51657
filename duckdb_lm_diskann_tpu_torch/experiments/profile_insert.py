"""Where a steady bulk-insert batch spends its time, on an index already
built.

The port of ``benchmarks/profile_insert.py``. ``profile(coord, rowids,
vectors, max_batch)`` times, at the steady ``max_batch`` shape:

  * two ``Coordinator.insert`` batches of ``max_batch`` new rows, end to
    end (inserts/s);
  * ``search_for_initial_candidates`` alone on the next batch's rows, at
    beam width 1 and 2 with the index's ``l_insert``: seconds, ``hops``,
    mean visits and lane utilisation ``mean_visits / (hops * width)`` (the
    lock-step packing waste);
  * "rest" = one steady batch - the width-1 search: the prune, the row
    writes and the reciprocal rounds.

The candidate search runs with ``assume_all_valid = not
coord._ever_tombstoned``, as ``Coordinator.insert`` passes it. On a CUDA
index the batches and the searches launch the codec's frontier kernel.
Run alone, it builds its own index first:

    python -m duckdb_lm_diskann_tpu_torch.experiments.profile_insert \\
        [N] [MAX_BATCH] [--device cuda]

``make_corpus(N + 4 * MAX_BATCH, 128)`` (default N = 500,000, MAX_BATCH =
2,048), L2, R = 64, L_insert = 128, alpha = 1.2, INT4 edges.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.searcher import search_for_initial_candidates


def profile(coord, rowids, vectors, max_batch, widths=(1, 2),
            out=print) -> dict:
    """Insert ``rowids[:2 * max_batch]`` (new rows) into ``coord`` in two
    batches of ``max_batch``, then time the candidate search on
    ``vectors[2 * max_batch : 3 * max_batch]`` at each beam width. Returns
    the numbers and prints a row each through ``out``."""
    mb = int(max_batch)
    if len(rowids) < 3 * mb or len(vectors) < 3 * mb:
        raise ValueError(f"profile_insert needs {3 * mb} new rows")
    dev = coord.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    old = coord.max_insert_batch
    coord.max_insert_batch = mb
    try:
        sync()
        t0 = time.perf_counter()
        coord.insert(rowids[: 2 * mb], vectors[: 2 * mb])
        sync()
        insert_s = time.perf_counter() - t0
    finally:
        coord.max_insert_batch = old
    rec = {"max_batch": mb, "insert_s": insert_s,
           "inserts_per_s": 2 * mb / insert_s, "search": {}}
    out(f"insert_batch x2 ({mb}): {insert_s:.3f} s = "
        f"{rec['inserts_per_s']:.0f} inserts/s steady")

    q = torch.as_tensor(
        np.ascontiguousarray(vectors[2 * mb : 3 * mb], np.float32), device=dev
    )
    all_valid = not coord._ever_tombstoned

    def search(width):
        return search_for_initial_candidates(
            coord.arrays, q, coord.entry_slot, params=coord.params,
            l_insert=coord.params.l_insert, beam_width=width,
            assume_all_valid=all_valid,
        )

    for width in widths:
        search(width)
        sync()
        t0 = time.perf_counter()
        res = search(width)
        sync()
        secs = time.perf_counter() - t0
        hops = int(res.hops)
        mean_visits = float(res.visited_count.float().mean())
        util = mean_visits / (hops * width)
        rec["search"][width] = {"s": secs, "hops": hops,
                                "mean_visits": mean_visits, "util": util}
        out(f"insert search W={width} (B={mb}): {secs:.3f} s  hops={hops}  "
            f"mean_visits={mean_visits:.1f}  util={util:.3f}")
    if 1 in rec["search"]:
        batch_s = insert_s / 2
        rec["rest_s"] = batch_s - rec["search"][1]["s"]
        rec["search_share"] = rec["search"][1]["s"] / batch_s
        out(f"steady batch {batch_s:.3f} s = W=1 search "
            f"{rec['search'][1]['s']:.3f} s + rest {rec['rest_s']:.3f} s "
            f"(prune, row writes, reciprocal rounds)")
    return rec


def main(argv=None) -> int:
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig
    from ..core.coordinator import Coordinator
    from ..utils.corpora import make_corpus

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=500_000)
    ap.add_argument("max_batch", type=int, nargs="?", default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, mb, dims = args.n, args.max_batch, 128
    gen, _ = make_corpus(n + 4 * mb, dims)
    data = gen(n + 4 * mb)
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=64, l_insert=128, alpha=1.2,
        l_search=100, dimensions=dims, node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.INT4,
    )
    cfg.validate()
    coord = Coordinator(cfg, initial_capacity=n + 4 * mb, device=args.device)
    if coord.device.type == "cuda":
        print(f"{torch.cuda.get_device_name(coord.device)}; torch "
              f"{torch.__version__}", flush=True)
    t0 = time.perf_counter()
    coord.bulk_build(range(n), data[:n], max_batch=mb)
    if coord.device.type == "cuda":
        torch.cuda.synchronize(coord.device)
    print(f"# built n={n} in {time.perf_counter() - t0:.1f} s", flush=True)
    rec = profile(coord, range(n, n + 3 * mb), data[n : n + 3 * mb], mb,
                  out=lambda s: print(s, flush=True))
    print(json.dumps({"profile_insert": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
