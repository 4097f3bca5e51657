"""A/B: streaming lane-refill search against lock-step batches, on an
index already built.

The port of ``benchmarks/ab_stream.py``. ``compare(coord, queries)``
runs

  * ``beam_search_many``: the queries in lock-step batches of ``batch``;
    a batch's hops are its slowest query's visits;
  * ``beam_search_stream`` at 512, 1,024 and 2,048 lanes (and any extra
    lane counts): a converged lane takes the next query, so the hops follow
    the total visits over the lanes;

and reports each one's QPS (best of ``reps`` after a warm-up call), hops,
visits per query, lane utilisation ``visits / (lanes * hops)`` and the
fraction of top-k slots equal to the lock-step ones. On the card the f32
reductions choose their order by shape, so the ids are identical only
where both sides compute over one shape: the match is printed, and held
(to 1.0, else ``AssertionError``) only at ``lanes == batch``. The searches
use ``assume_all_valid = not coord._ever_tombstoned``, as
``Coordinator.search`` does. Run alone, it builds its own index first:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_stream \\
        [N] [manifold|hard] [EXTRA_LANES,...] [--device cuda]

(default N = 200,000, 128-d, L2, R = 64, L_insert = 128, INT4, build
batches of 2,048; 4,096 queries near corpus rows, top-10 at L = 100).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.searcher import beam_search_many, beam_search_stream

LANES = (512, 1024, 2048)


def compare(coord, queries, *, k=10, l_search=100, batch=1024, lanes=LANES,
            reps=3, out=print) -> dict:
    """Lock-step batches of ``batch`` against the stream at each lane
    count, on ``queries`` (a multiple of ``batch`` rows). Returns the rows
    and prints one each through ``out``."""
    view = coord.capture_view()
    dev = view.arrays.device
    nq, dims = queries.shape
    if nq % batch:
        raise ValueError(f"{nq} queries are not whole batches of {batch}")
    q_dev = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=dev)
    entry = torch.as_tensor(view.seeds, device=dev)
    opts = dict(params=coord.params, l_search=l_search, k=k,
                assume_all_valid=not view.ever_tombstoned)

    def timed(fn):
        res = fn()
        int(res.hops.sum())  # reads the results: the call is done
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            int(fn().hops.sum())
            best = min(best, time.perf_counter() - t0)
        return best, res

    t_many, res_m = timed(lambda: beam_search_many(
        view.arrays, q_dev.reshape(nq // batch, batch, dims), entry, **opts))
    hops_m = int(res_m.hops.sum())
    visits = int(res_m.visited_count.sum())
    ids_m = res_m.topk_slots.reshape(nq, k).cpu().numpy()
    many = {"batch": batch, "qps": nq / t_many, "hops": hops_m,
            "visits_per_query": visits / nq,
            "util": visits / (hops_m * batch)}
    out(f"many   B={batch}: {many['qps']:9.1f} qps  hops={hops_m}  "
        f"visits/q={many['visits_per_query']:.1f}  util={many['util']:.3f}")
    streams = []
    for n_lanes in lanes:
        t_s, res_s = timed(lambda n_lanes=n_lanes: beam_search_stream(
            view.arrays, q_dev, entry, lanes=n_lanes, **opts))
        hops_s = int(res_s.hops)
        visits_s = int(res_s.visited_count.sum())
        match = float((res_s.topk_slots.cpu().numpy() == ids_m).mean())
        row = {"lanes": n_lanes, "qps": nq / t_s, "hops": hops_s,
               "visits_per_query": visits_s / nq,
               "util": visits_s / (hops_s * min(n_lanes, nq)),
               "id_match": match}
        streams.append(row)
        out(f"stream lanes={n_lanes:5d}: {row['qps']:9.1f} qps  hops={hops_s}"
            f"  visits/q={row['visits_per_query']:.1f}  util={row['util']:.3f}"
            f"  id-match={match:.4f}")
        if n_lanes == batch and match != 1.0:
            raise AssertionError(
                f"stream lanes={n_lanes}: ids != lock-step batches of "
                f"{batch} (match {match})")
    return {"queries": nq, "many": many, "stream": streams}


def main(argv=None) -> int:
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig
    from ..core.coordinator import Coordinator
    from ..utils.corpora import make_corpus, make_hard_corpus

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=200_000)
    ap.add_argument("corpus", nargs="?", default="manifold",
                    choices=("manifold", "hard"))
    ap.add_argument("extra_lanes", nargs="?", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dims, nq = args.n, 128, 4096
    if args.corpus == "hard":
        gen, rng = make_hard_corpus(n, dims, 0x4A2D)
    else:
        gen, rng = make_corpus(n, dims)
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
    print(f"# built n={n} ({args.corpus}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    extra = [int(x) for x in args.extra_lanes.split(",") if x]
    rec = compare(coord, queries, lanes=(*LANES, *extra),
                  out=lambda s: print(s, flush=True))
    print(json.dumps({"ab_stream": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
