"""Knockout profile of the port's real beam-search hop.

The port of ``benchmarks/profile_searcher.py``. ``experiments/profile_hop.py``
times a stripped copy of the hop; this script mirrors the real one,
``core/searcher.py``'s ``_hop`` and its caller's visited-log append,
statement for statement at E = 1, calling the searcher's own
``_score_edges`` (the INT4 frontier kernel on a CUDA tensor), with each
component switchable:

    escore   the frontier scores from the visited node's cached codes
    vgather  the visited node's vector gather and exact distance
    nbrlive  the neighbor-validity gather ``arrays.valid[nbrs]``
    vislog   the visited-log scatters (slots and distances)
    merge    the searcher's own merge call (``kernels.beam_merge``: the
             beam-membership and visited-seed tests, the sorted merge and
             the slot normalisation; one kernel launch on a CUDA tensor)
    seedvis  the seed-visit tracking

Rows: ``full``, each component knocked out (``-X``: its cost is ``full``
minus the row) and ``bare(min)`` (all six out). ``valid=False`` knocks
``nbrlive`` out of every row: the serving hop, which searches with
``assume_all_valid``. The gap between this ``full`` and ``profile_hop``'s
is what the copy missed. The loop's own control (the hop count and the
host's read of the loop condition every ``_CHECK_EVERY`` hops) is not in
the mirror: ``profile_real`` times the searcher with it.

Each cost is the slope of time against hops between ITERS_LO and ITERS_HI
(``utils/cuda_timing.slope_ms``): ``wall``, the loop issued to an idle
card, and ``on the card``, the loop issued in chunks behind sleep kernels.
The tables are ``profile_real.make_tables``'s (2^20 random rows, B = 1024,
L = 100, R = 64, D = 128, INT4). Run alone:

    python -m duckdb_lm_diskann_tpu_torch.experiments.profile_searcher \\
        [--b 1024] [--l 100] [--cap-log2 20] [--valid 1|0|both]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core import searcher
from ..kernels.beam_merge import beam_merge
from ..ops.distance import pairwise_distance
from ..utils import cuda_timing
from .profile_real import CAP_LOG2, B, L, HopTables, _device, make_tables

ITERS_LO, ITERS_HI = 48, 160
INF = float("inf")
COMPONENTS = ("escore", "vgather", "nbrlive", "vislog", "merge", "seedvis")
KNOCKOUTS = (
    ("full", {}),
    *((f"-{c}", {c: False}) for c in COMPONENTS),
    ("bare(min)", {c: False for c in COMPONENTS}),
)


def initial_state(seed_slot: torch.Tensor, l: int, v: int):
    """A fresh search state (beam_dist, beam_slot, beam_vis, seed_vis,
    vis_slot, vis_dist, vis_cnt): each lane's beam holds its seed slot at
    distance 0; the seed set is slot 0 alone; the visited log has V
    columns and the searcher's scratch column."""
    b, dev = seed_slot.shape[0], seed_slot.device
    beam_dist = torch.full((b, l), INF, device=dev)
    beam_dist[:, 0] = 0.0
    beam_slot = torch.full((b, l), -1, dtype=torch.int32, device=dev)
    beam_slot[:, 0] = seed_slot
    return (
        beam_dist, beam_slot,
        torch.zeros((b, l), dtype=torch.bool, device=dev),
        torch.zeros((b, 1), dtype=torch.bool, device=dev),
        torch.full((b, v + 1), -1, dtype=torch.int32, device=dev),
        torch.full((b, v + 1), INF, device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def make_step(tables: HopTables, *, escore=True, vgather=True, nbrlive=True,
              vislog=True, merge=True, seedvis=True):
    """``step(state, i) -> state``: one hop of ``searcher._hop`` (E = 1,
    ``assume_all_valid`` = not ``nbrlive``) and the visited-log append of
    ``searcher.beam_search``, with the named components knocked out. The
    state's tensors are updated in place where the searcher updates
    them."""
    arrays, params, queries = tables
    q = queries[0]
    b, l, r = q.shape[0], params.l_search, params.r
    v = params.max_visits
    seeds_b = torch.zeros((b, 1), dtype=torch.int32, device=q.device)

    def step(s, i):
        beam_dist, beam_slot, beam_vis, seed_vis, vis_slot, vis_dist, vis_cnt = s
        unvis = ~beam_vis & (beam_slot >= 0)
        idx_e = unvis.to(torch.uint8).argmax(-1, keepdim=True)  # [B, 1]
        active = unvis.gather(1, idx_e)
        cur = torch.where(active, beam_slot.gather(1, idx_e), 0)
        cur_f = cur.reshape(-1)

        if vgather:
            node_vec = arrays.vectors.index_select(0, cur_f).float()
            exact = pairwise_distance(q, node_vec, params.metric).reshape(b, 1)
        else:
            exact = beam_dist[:, :1] * 1.0001
        beam_vis.scatter_(1, idx_e, beam_vis.gather(1, idx_e) | active)
        if seedvis:
            seed_vis |= (
                (cur[:, :, None] == seeds_b[:, None, :]) & active[:, :, None]
            ).any(1)

        nbrs = arrays.neighbors.index_select(0, cur_f)  # [B, R]
        live = nbrs >= 0
        if nbrlive:
            live = live & arrays.valid[nbrs.clamp_min(0).long()]
        live = live & active.reshape(-1, 1)
        if escore:
            edge_dist = searcher._score_edges(arrays, params, cur_f, q, None,
                                              nbrs)
        else:
            edge_dist = nbrs.float() * 1e-7 + exact
        if merge:
            beam_merge(
                beam_dist, beam_slot, beam_vis, nbrs.reshape(b, 1, r),
                edge_dist.reshape(b, 1, r), live.reshape(b, 1, r), seeds_b,
                seed_vis,
            )
        else:
            cand_dist = torch.where(live, edge_dist, INF)
            cand_slot = torch.where(live, nbrs, -1)
            m = min(l, r)
            new_dist = beam_dist.clone()
            new_dist[:, :m] = torch.minimum(
                beam_dist[:, :m], cand_dist[:, :m] * 0.999
            )
            pad = torch.full((b, l - m), -1, dtype=torch.int32,
                             device=q.device)
            beam_slot = torch.where(
                new_dist < beam_dist, torch.cat([cand_slot[:, :m], pad], 1),
                beam_slot,
            )
            beam_dist = new_dist
            beam_slot = torch.where(
                torch.isinf(beam_dist), torch.full_like(beam_slot, -1),
                beam_slot,
            )

        if vislog:
            order = active.to(torch.int32).cumsum(-1) - 1
            pos = torch.where(active, vis_cnt[:, None] + order, v)
            pos = pos.clamp_max(v).long()
            vis_slot.scatter_(1, pos, cur)
            vis_dist.scatter_(1, pos, exact)
        vis_cnt += active.sum(-1, dtype=torch.int32)
        return (beam_dist, beam_slot, beam_vis, seed_vis, vis_slot, vis_dist,
                vis_cnt)

    return step


def seed_slots(tables: HopTables, n=8):
    """``n`` batches of random start slots (one per lane)."""
    arrays, _, queries = tables
    gen = torch.Generator(device=arrays.device).manual_seed(7)
    return [
        torch.randint(0, arrays.capacity, (queries[0].shape[0],),
                      dtype=torch.int32, device=arrays.device, generator=gen)
        for _ in range(n)
    ]


def knockout(device="cuda", tables: HopTables | None = None, *, valid=True,
             iters=(ITERS_LO, ITERS_HI), reps=4, out=print) -> list[dict]:
    """ms per hop of the full mirror, each knockout and ``bare(min)`` on
    ``tables`` (made on ``device`` when None); ``valid=False`` knocks
    ``nbrlive`` out of every row. Prints a row each through ``out`` and
    returns them (``device_ms_per_hop`` None off the card)."""
    if tables is None:
        tables = make_tables(device)
    params = tables.params
    states = [initial_state(s, params.l_search, params.max_visits)
              for s in seed_slots(tables)]
    base = {} if valid else {"nbrlive": False}
    rows = []
    for name, kw in KNOCKOUTS:
        wall, card = cuda_timing.slope_ms(
            make_step(tables, **{**base, **kw}), states, *iters, reps=reps,
        )
        out(f"valid={int(valid)} {name:10s}: {wall:.3f} ms/hop wall, "
            + ("not measured" if card is None else f"{card:.3f} ms/hop")
            + " on the card")
        rows.append({"variant": name, "valid": valid, "ms_per_hop": wall,
                     "device_ms_per_hop": card})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=B)
    ap.add_argument("--l", type=int, default=L)
    ap.add_argument("--cap-log2", type=int, default=CAP_LOG2)
    ap.add_argument("--valid", choices=("1", "0", "both"), default="1",
                    help="0: nbrlive out of every row (the serving hop)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    tables = make_tables(dev, cap_log2=args.cap_log2, b=args.b, l=args.l)
    modes = {"1": (True,), "0": (False,), "both": (True, False)}[args.valid]
    rows = [row for valid in modes for row in knockout(
        dev, tables, valid=valid, out=lambda s: print(s, flush=True))]
    print(json.dumps({"profile_searcher": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
