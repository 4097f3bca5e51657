"""Profiling harness for the beam-search hop at 1M scale, on one CUDA card.

The port of ``benchmarks/profile_hop.py``. Run it as

    python -m duckdb_lm_diskann_tpu_torch.experiments.profile_hop [knockout|gather]

or call ``knockout(dev)`` / ``gather_ab(dev)`` (``chip_smoke.py`` does).
Importing the module touches neither the card nor any table.

``knockout`` (default): a stripped copy of the port's E=1 hop
(``core/searcher.py``) at the headline's shapes (B=1024, L=100, R=64,
D=128, INT4 edges, 2^20 rows of random tables), run with one component
knocked out at a time; a component's cost is ``full`` minus its row:

    -merge       the searcher's merge (``kernels/beam_merge``: the
                 beam-membership test, the sorted merge and the slot
                 normalisation, one kernel launch)
    -edgegather  the INT4 frontier kernel (``kernels/int4_frontier``)
    -vislog      the visited-log scatter
    -vecgather   the node-vector gather and exact distance
    bare(min)    all four out: the loop skeleton

``gather``: the row-gather A/B over the same 5,120-byte rows: today's four
SoA gathers (vectors / neighbors / INT4 codes / scales) against one
combined self-contained row u32[2^20, 1280] (the reference's one block
read per visit), each through ``index_select``, and through the port's
row-gather kernel (``kernels/row_gather``, the port of the TPU kernels
``_pipelined_gather`` and ``_pipelined_gather4``) with n_flight = K rows in
flight. The kernel is checked equal to ``index_select`` before any timing;
each kernel row carries the launch plan of its last call
(``row_gather.LAST_PLAN``: blocks, threads, row groups of K, column units
and their width per table).

Every cost is the SLOPE of time against loop iterations between
``ITERS_LO`` and ``ITERS_HI``, timed with CUDA events around a Python loop,
so fixed per-call costs cancel: ``wall``, the loop issued to an idle card
(what a search pays per hop, host launch path included: the hop loop is
host-bound). Beside it, ``on the card``: the loop issued in short chunks,
each behind a sleep kernel, so that the events time the card's work alone
(``utils/cuda_timing.slope_ms``).
"""

from __future__ import annotations

import sys

import torch

from ..common.types import MetricType
from ..kernels.beam_merge import beam_merge
from ..kernels.int4_frontier import int4_frontier_scores
from ..kernels import row_gather
from ..kernels.row_gather import pipelined_gather, pipelined_gather4
from ..ops.distance import pairwise_distance
from ..utils import cuda_timing

B, L, R, D = 1024, 100, 64, 128
CAP = 1 << 20
ITERS_LO, ITERS_HI = 64, 256
V = 4 * L
# u32 words of one self-contained row: vector | neighbors | scales | codes.
ROW = D + R + R + R * (D // 2) // 4
INF = float("inf")


def _seeds(dev, n=8):
    gen = torch.Generator(device=dev).manual_seed(7)
    return [
        torch.randint(0, CAP, (B,), dtype=torch.int32, device=dev, generator=gen)
        for _ in range(n)
    ]


def _hop_step(tables, *, merge=True, egather=True, vislog=True,
              vgather=True):
    """The port's E=1 hop with the named components knocked out."""
    vectors, edge_i4, edge_scale, neighbors, queries = tables
    l2 = MetricType.L2
    dev = queries.device
    live = torch.ones((B, 1, R), dtype=torch.bool, device=dev)
    seeds = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    seed_vis = torch.zeros((B, 1), dtype=torch.bool, device=dev)

    def step(s, i):
        beam_dist, beam_slot, beam_vis, vis_slot, vis_dist, vis_cnt = s
        unvis = ~beam_vis & (beam_slot >= 0)
        idx = unvis.to(torch.uint8).argmax(-1, keepdim=True)
        active = unvis.gather(1, idx)
        cur = torch.where(active, beam_slot.gather(1, idx), 0)[:, 0]
        if vgather:
            exact = pairwise_distance(queries, vectors.index_select(0, cur), l2)
        else:
            exact = beam_dist[:, 0] * 1.0001
        beam_vis.scatter_(1, idx, beam_vis.gather(1, idx) | active)
        if vislog:
            pos = torch.where(active[:, 0], vis_cnt, V).clamp_max(V).long()
            vis_slot.scatter_(1, pos[:, None], cur[:, None])
            vis_dist.scatter_(1, pos[:, None], exact[:, None])
        else:
            vis_slot[:, 0] += cur
            vis_dist[:, 0] += exact
        vis_cnt += active[:, 0].to(torch.int32)

        nbrs = neighbors.index_select(0, cur)
        if egather:
            edge_dist = int4_frontier_scores(
                cur, queries, edge_i4, edge_scale, metric=l2
            )
        else:
            edge_dist = nbrs.float() * 1e-7 + exact[:, None]
        if merge:
            beam_merge(beam_dist, beam_slot, beam_vis, nbrs[:, None],
                       edge_dist[:, None], live, seeds, seed_vis)
            return (beam_dist, beam_slot, beam_vis, vis_slot, vis_dist,
                    vis_cnt)
        m = min(L, R)
        new_dist = beam_dist.clone()
        new_dist[:, :m] = torch.minimum(beam_dist[:, :m], edge_dist[:, :m] * 0.999)
        pad = torch.full((B, L - m), -1, dtype=torch.int32, device=dev)
        new_slot = torch.where(
            new_dist < beam_dist, torch.cat([nbrs[:, :m], pad], 1), beam_slot,
        )
        new_slot = torch.where(torch.isinf(new_dist), -1, new_slot)
        return (new_dist, new_slot, beam_vis, vis_slot, vis_dist, vis_cnt)

    return step


KNOCKOUTS = (
    ("full", {}),
    ("-merge", dict(merge=False)),
    ("-edgegather", dict(egather=False)),
    ("-vislog", dict(vislog=False)),
    ("-vecgather", dict(vgather=False)),
    ("bare(min)", dict(merge=False, egather=False, vislog=False,
                       vgather=False)),
)


def knockout(dev, out=print) -> list[dict]:
    """ms per hop of the full hop and of each knockout; prints a row each
    through ``out`` and returns them. The ~5.4 GB of tables are freed on
    return."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = (
        torch.randn((CAP, D), device=dev, generator=gen),
        # planar INT4 words: every nibble value
        torch.randint(-(2**31), 2**31, (CAP, R, D // 8), dtype=torch.int32,
                      device=dev, generator=gen),
        torch.rand((CAP, R), device=dev, generator=gen),
        torch.randint(0, CAP, (CAP, R), dtype=torch.int32, device=dev,
                      generator=gen),
        torch.randn((B, D), device=dev, generator=gen),
    )
    out(f"knockout tables resident: "
        f"{sum(t.nbytes for t in tables) / 2**30:.2f} GiB")

    def state(seed):
        beam_dist = torch.full((B, L), INF, device=dev)
        beam_dist[:, 0] = 0.0
        beam_slot = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        beam_slot[:, 0] = seed
        return (
            beam_dist, beam_slot,
            torch.zeros((B, L), dtype=torch.bool, device=dev),
            torch.full((B, V + 1), -1, dtype=torch.int32, device=dev),
            torch.full((B, V + 1), INF, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
        )

    states = [state(s) for s in _seeds(dev)]
    rows = []
    for name, kw in KNOCKOUTS:
        wall, card = cuda_timing.slope_ms(
            _hop_step(tables, **kw), states, ITERS_LO, ITERS_HI
        )
        out(f"{name:12s}: {wall:.3f} ms/hop wall, {card:.3f} ms/hop on the card")
        rows.append({"variant": name, "ms_per_hop": wall,
                     "device_ms_per_hop": card})
    return rows


def gather_ab(dev, out=print) -> list[dict]:
    """ms per iteration of each row-gather variant over B=1024 rows of
    5,120 bytes; prints a row each through ``out`` and returns them. The
    kernel is held equal to index_select first (raises if not). The
    ~10.7 GB of tables are freed on return."""
    gen = torch.Generator(device=dev).manual_seed(0)
    vec = torch.randn((CAP, D), device=dev, generator=gen).view(torch.int32)
    nbr = torch.randint(0, CAP, (CAP, R), dtype=torch.int32, device=dev,
                        generator=gen)
    sc = torch.rand((CAP, R), device=dev, generator=gen).view(torch.int32)
    codes = torch.randint(-(2**31), 2**31, (CAP, R * (D // 2) // 4),
                          dtype=torch.int32, device=dev, generator=gen)
    sep4 = (vec, nbr, sc, codes)
    combined = torch.cat(sep4, 1)
    assert combined.shape == (CAP, ROW)
    out(f"gather tables resident: "
        f"{(combined.nbytes + sum(t.nbytes for t in sep4)) / 2**30:.2f} GiB")

    seeds = _seeds(dev)
    # Hard equality checks before any timing.
    for k in (4, 8, 16):
        got = pipelined_gather(seeds[0], combined, n_flight=k)
        if not torch.equal(got, combined.index_select(0, seeds[0].long())):
            raise AssertionError(f"row gather kernel != index_select (K={k})")
    for k in (8, 16):
        got = pipelined_gather4(seeds[0], sep4, n_flight=k)
        for g, t in zip(got, sep4):
            if not torch.equal(g, t.index_select(0, seeds[0].long())):
                raise AssertionError(f"row gather4 kernel != index_select (K={k})")
    out("row gather kernel == index_select (combined K=4/8/16, sep4 K=8/16)")

    def rowsum(t):
        return t.sum(-1)  # int64[B], depends on every gathered word

    def take(t):
        return lambda idx: rowsum(t.index_select(0, idx.long()))

    variants = [
        ("sep4 (today)",
         lambda idx: sum(rowsum(t.index_select(0, idx.long())) for t in sep4)),
        ("combined x1", take(combined)),
        ("vec only", take(vec)),
        ("codes only", take(codes)),
    ]
    for k in (4, 8, 16):
        variants.append((
            f"kernel comb K={k}",
            lambda idx, k=k: rowsum(pipelined_gather(idx, combined, n_flight=k)),
        ))
    for k in (8, 16):
        variants.append((
            f"kernel sep4 K={k}",
            lambda idx, k=k: sum(
                rowsum(o) for o in pipelined_gather4(idx, sep4, n_flight=k)
            ),
        ))

    rows = []
    for name, fn in variants:
        def step(s, i, fn=fn):
            (idx,) = s
            # The next rows depend on the gathered bytes: no overlap across
            # iterations.
            return (((idx.long() + fn(idx) + i) & (CAP - 1)).to(torch.int32),)

        row_gather.LAST_PLAN = None
        wall, card = cuda_timing.slope_ms(
            step, [(s,) for s in seeds], ITERS_LO, ITERS_HI
        )
        plan = row_gather.LAST_PLAN
        out(f"{name:18s}: {wall:.3f} ms/iter wall, {card:.4f} ms/iter on the "
            f"card ({card * 1e6 / B:.1f} ns/row)"
            + (f", plan {plan._asdict()}" if plan else ""))
        rows.append({"variant": name, "ms_per_iter": wall,
                     "device_ms_per_iter": card,
                     **({"plan": plan._asdict()} if plan else {})})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "knockout"
    if mode not in ("knockout", "gather"):
        raise SystemExit(f"unknown mode {mode!r}: knockout or gather")
    if not torch.cuda.is_available():
        raise SystemExit("profile_hop: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
          flush=True)
    (gather_ab if mode == "gather" else knockout)(
        dev, out=lambda s: print(s, flush=True)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
