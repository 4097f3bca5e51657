"""Slope profile of the port's real ``core/searcher.beam_search``.

The port of ``benchmarks/profile_real.py``. ``experiments/profile_hop.py``
and ``experiments/profile_searcher.py`` time copies of the hop in a bare
loop; this script times the searcher itself at two forced visit caps
(``max_visits`` V_LO and V_HI: at E = 1 the loop runs while ``it < V``)
and reports

    per-hop slope   = (t(V_HI) - t(V_LO)) / (V_HI - V_LO)
    fixed intercept = t(V_LO) - slope * V_LO  (seed prefix, re-rank, launches)

The cap must bind, not convergence (the loop also stops once no lane has
an unvisited entry, read every ``_CHECK_EVERY`` hops): every query batch
is searched at both caps first, only the batches whose ``hops`` equal both
caps are timed, and it raises if none does or if a timed call ran other
hops. On random rows a lane converges a little after L visits and a
batch of 1,024 lanes ends with its slowest lane, near 160 (one batch of 8
ended at 159 hops on an NVIDIA H100): hence several batches. The
re-rank sorts the [B, V] visited log, so the two caps also change its
size: ``sorted_dedup_topk`` is timed
alone at [B, V_LO] and [B, V_HI] and the corrected slope takes the
difference out.

Each time comes two ways (``utils/cuda_timing.py``): ``wall``, the best of
``reps`` calls between CUDA events on an idle card, host launch path and
the searcher's own reads of its loop condition included; and ``on the
card`` (``card_profile``, after every wall time), the card's busy time
during the call in a ``torch.profiler`` trace (``cuda_timing.kernel_ms``).
A search waits on the card every ``_CHECK_EVERY`` hops, so it cannot be
issued behind a sleep as the copies' loops are. On the CPU
(``device="cpu"``, the tests) ``wall`` is the host clock and there is no
card time.

Tables (``make_tables``): 2^20 random rows at B = 1024, L = 100, R = 64,
D = 128, INT4 planar codes and scales, searched with ``assume_all_valid``;
on a CUDA tensor every hop launches the INT4 frontier kernel.
``profile_searcher.knockout`` takes the same tables. Run alone:

    python -m duckdb_lm_diskann_tpu_torch.experiments.profile_real \\
        [--cap-log2 20] [--b 1024] [--l 100] [--v-lo 48] [--v-hi 160]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import torch

from ..common.types import EdgeType, MetricType
from ..core import searcher
from ..core.graph import GraphArrays, GraphParams
from ..ops import topk as topk_ops
from ..ops.quantize import words_per_i4
from ..utils import cuda_timing

B, L, R, D = 1024, 100, 64, 128
CAP_LOG2 = 20
V_LO, V_HI = 48, 160
# Profiler traces per timing for the card's time (each traces a whole call;
# the card's busy time barely varies between calls).
CARD_REPS = 1


class HopTables(NamedTuple):
    """Random index tables and query batches for the hop profilers."""

    arrays: GraphArrays
    params: GraphParams
    queries: list  # f32[B, D] tensors


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev}: CUDA is not available")
    return dev


def hop_params(l: int = L, d: int = D, r: int = R) -> GraphParams:
    return GraphParams(
        dims=d, r=r, metric=MetricType.L2, edge_type=EdgeType.INT4,
        alpha=1.2, l_insert=128, l_search=l, max_visits=4 * l,
    )


def _arrays(vectors, neighbors, edge_i4, edge_scale) -> GraphArrays:
    cap, dev = vectors.shape[0], vectors.device

    def empty(dtype):
        return torch.zeros((cap, 0, 0), dtype=dtype, device=dev)

    return GraphArrays(
        vectors=vectors,
        neighbors=neighbors,
        valid=torch.ones(cap, dtype=torch.bool, device=dev),
        edge_pos=empty(torch.int32),
        edge_neg=empty(torch.int32),
        edge_i8=empty(torch.int8),
        edge_i4=edge_i4,
        edge_scale=edge_scale,
        edge_f32=empty(torch.float32),
        dirty_rows=torch.zeros(cap, dtype=torch.bool, device=dev),
    )


def make_tables(device="cuda", *, cap_log2=CAP_LOG2, b=B, l=L, n_queries=8,
                seed=0) -> HopTables:
    """2^cap_log2 rows of random tables made on ``device`` from ``seed``:
    f32 vectors, neighbor slots over every row, planar INT4 words holding
    every bit pattern and f32 scales in [0, 1); ``n_queries`` batches of
    ``b`` random queries (about 5.4 GB at 2^20 rows)."""
    dev = _device(device)
    cap = 1 << cap_log2
    gen = torch.Generator(device=dev).manual_seed(seed)
    arrays = _arrays(
        torch.randn((cap, D), device=dev, generator=gen),
        torch.randint(0, cap, (cap, R), dtype=torch.int32, device=dev,
                      generator=gen),
        torch.randint(-(2**31), 2**31, (cap, R, words_per_i4(D)),
                      dtype=torch.int32, device=dev, generator=gen),
        torch.rand((cap, R), device=dev, generator=gen),
    )
    queries = [torch.randn((b, D), device=dev, generator=gen)
               for _ in range(n_queries)]
    return HopTables(arrays, hop_params(l), queries)


def tables_from_numpy(vectors, neighbors, edge_i4, edge_scale, queries,
                      l=L, device="cpu") -> HopTables:
    """The same tables from host arrays (INT4 words as uint32 or int32 with
    the same bits), so that another implementation can search the very
    same rows."""
    dev = _device(device)

    def t(a):
        a = a.view("int32") if a.dtype == "uint32" else a
        return torch.from_numpy(a.copy()).to(dev)

    d, r = vectors.shape[1], neighbors.shape[1]
    return HopTables(
        _arrays(t(vectors), t(neighbors), t(edge_i4), t(edge_scale)),
        hop_params(l, d, r), [t(q) for q in queries],
    )


def _search_at(tables, v, k):
    arrays, params, _ = tables
    return lambda q: searcher.beam_search(
        arrays, q, 0, params=params, l_search=params.l_search, k=k,
        max_visits=v, assume_all_valid=True,
    )


def _rerank_at(tables, v):
    """``sorted_dedup_topk`` alone over a random [B, v] visited log."""
    arrays, _, queries = tables
    dev = arrays.device
    gen = torch.Generator(device=dev).manual_seed(v)
    vd = torch.rand((queries[0].shape[0], v), device=dev, generator=gen)
    vs = torch.randint(0, arrays.capacity, vd.shape, dtype=torch.int32,
                       device=dev, generator=gen)
    return lambda q: topk_ops.sorted_dedup_topk(vd, vs)


def _binding_batches(tables, caps, k, out):
    """Each query batch searched at each cap: (hops per cap, the batches
    whose hops equal every cap, each cap's result on the first batch).
    RuntimeError if no batch binds."""
    queries = tables.queries
    runs = {v: [_search_at(tables, v, k)(q) for q in queries] for v in caps}
    hops = {v: [int(res.hops) for res in runs[v]] for v in caps}
    bound = [q for i, q in enumerate(queries)
             if all(hops[v][i] == v for v in caps)]
    out(f"hops of each query batch at V={caps[0]}: {hops[caps[0]]}; at "
        f"V={caps[1]}: {hops[caps[1]]}; {len(bound)} of {len(queries)} "
        f"batches bind both")
    if not bound:
        raise RuntimeError(
            f"profile_real: no query batch ran the caps {caps} (hops {hops}):"
            f" every one converged before the cap bound"
        )
    return hops, bound, {v: runs[v][0] for v in caps}


def _best(measure, fn, queries, reps, hops=None):
    """The least of ``measure(run)`` over ``reps`` calls of ``fn(q)``
    rotating over ``queries``; ``hops``: every call must have run that
    many hops (RuntimeError otherwise)."""
    results, times = [], []
    for i in range(reps):
        q = queries[i % len(queries)]
        times.append(measure(lambda: results.append(fn(q))))
    if hops is not None:
        got = sorted({int(res.hops) for res in results})
        if got != [hops]:
            raise RuntimeError(
                f"profile_real: timed calls ran {got} hops, not the cap {hops}"
            )
    return None if None in times else min(times)


def _wall_ms(run):
    """Between CUDA events around ``run()`` issued to an idle card."""
    return cuda_timing.wall_ms(lambda _: run(), 1)[0]


def _slopes(tables, measure, caps, bound, k, reps, label, out):
    """Times at both caps and of the re-rank alone, the raw and corrected
    per-hop slopes and the fixed intercept, by ``measure``."""
    v_lo, v_hi = caps
    t = {v: _best(measure, _search_at(tables, v, k), bound, reps, hops=v)
         for v in caps}
    rr = {v: _best(measure, _rerank_at(tables, v), bound, reps) for v in caps}
    if None in (*t.values(), *rr.values()):
        out(f"{label}: not measured")
        return None
    slope = (t[v_hi] - t[v_lo] - (rr[v_hi] - rr[v_lo])) / (v_hi - v_lo)
    m = {
        "t_lo_ms": t[v_lo], "t_hi_ms": t[v_hi],
        "rerank_lo_ms": rr[v_lo], "rerank_hi_ms": rr[v_hi],
        "raw_slope_ms": (t[v_hi] - t[v_lo]) / (v_hi - v_lo),
        "slope_ms": slope,
        "fixed_ms": t[v_lo] - slope * v_lo,
    }
    out(f"{label}: t(V={v_lo}) = {m['t_lo_ms']:.3f} ms   t(V={v_hi}) = "
        f"{m['t_hi_ms']:.3f} ms; re-rank alone {m['rerank_lo_ms']:.3f} ms"
        f" @ {v_lo}, {m['rerank_hi_ms']:.3f} ms @ {v_hi}")
    out(f"{label}: per-hop slope raw {m['raw_slope_ms']:.4f} ms, "
        f"re-rank corrected {m['slope_ms']:.4f} ms; fixed (seed prefix + "
        f"re-rank@{v_lo} + launches) {m['fixed_ms']:.3f} ms")
    return m


def card_profile(tables: HopTables, *, v_lo=V_LO, v_hi=V_HI, k=10,
                 reps=CARD_REPS, out=print) -> dict | None:
    """The ``on the card`` column alone: the card's busy time of each call
    in a ``torch.profiler`` trace, None when the trace shows no device
    activity. A process takes it after all its wall times: on an NVIDIA
    H100, this script's wall at V_LO took 54.25 ms before a profiler
    session in the same process and 96.50 ms after it."""
    caps = (v_lo, v_hi)
    _, bound, _ = _binding_batches(tables, caps, k, out)

    def measure(run):
        return cuda_timing.kernel_ms(run)

    return _slopes(tables, measure, caps, bound, k, reps, "on the card", out)


def profile(device="cuda", tables: HopTables | None = None, *, v_lo=V_LO,
            v_hi=V_HI, k=10, reps=5, card=True, out=print) -> dict:
    """Time ``beam_search`` at the caps ``v_lo`` and ``v_hi`` on
    ``tables`` (made on ``device`` when None) and the re-rank alone at
    both log sizes. Every query batch is searched at both caps first, and
    only the batches whose hops equal both caps are timed (RuntimeError
    if none does): the cap must bind, not convergence. Returns the times,
    slopes and intercepts (``wall``; ``card`` from ``card_profile`` after
    them when ``card`` and on the card, else None), each batch's hops
    and, under ``results``, each cap's SearchResult on the first batch;
    prints the rows through ``out``."""
    if tables is None:
        tables = make_tables(device)
    arrays, params, queries = tables
    caps = (v_lo, v_hi)
    hops, bound, results = _binding_batches(tables, caps, k, out)
    rows = {"rows": arrays.capacity, "b": queries[0].shape[0],
            "l": params.l_search, "v_lo": v_lo, "v_hi": v_hi,
            "batch_hops": hops, "batches_timed": len(bound)}
    on_card = arrays.device.type == "cuda"
    measure = _wall_ms if on_card else cuda_timing.host_clock_ms
    rows["wall"] = _slopes(tables, measure, caps, bound, k, reps, "wall", out)
    rows["card"] = (
        card_profile(tables, v_lo=v_lo, v_hi=v_hi, k=k, out=out)
        if card and on_card else None
    )
    rows["results"] = results
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap-log2", type=int, default=CAP_LOG2)
    ap.add_argument("--b", type=int, default=B)
    ap.add_argument("--l", type=int, default=L)
    ap.add_argument("--v-lo", type=int, default=V_LO)
    ap.add_argument("--v-hi", type=int, default=V_HI)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    tables = make_tables(dev, cap_log2=args.cap_log2, b=args.b, l=args.l)
    rows = profile(dev, tables, v_lo=args.v_lo, v_hi=args.v_hi,
                   reps=args.reps, out=lambda s: print(s, flush=True))
    rows.pop("results")
    print(json.dumps({"profile_real": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
