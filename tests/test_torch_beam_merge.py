"""The hop's beam merge (``kernels/beam_merge.py``).

On the CPU the wrapper runs its plain form, held here against a NumPy
tuple-sort oracle of the same function (no JAX): the beam and the
surviving candidates sorted by (distance, slot) with Python's stable sort,
NaN after +inf and -0.0 equal to +0.0, and at E > 1 each slot's later
copies in (slot, distance, position) order dropped to (+inf, -1) first.
The output must be bit-identical. The recorded searches of the other port
tests (``test_torch_golden_traces.py``, ``test_torch_serving.py``, ...)
hold the whole hop.

The ``cuda`` tests hold the kernel bit-identical to the plain form at the
benchmark cells' shapes, E = 1, 2 and 4; they need a card and skip without
one (``chip_smoke.py`` makes the same check).
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import searcher
from duckdb_lm_diskann_tpu_torch.experiments import profile_real
from duckdb_lm_diskann_tpu_torch.kernels import beam_merge as bm
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

INF = np.float32(np.inf)
SPECIAL = np.array([-0.0, 0.0, 0.5, 0.5, 1.0, -1.0, np.inf, -np.inf, np.nan],
                   np.float32)


def random_lanes(rng, B, L, E, R, S, *, special=False):
    """Numpy inputs of ``beam_merge`` shaped like a hop's: each beam sorted
    by (distance, slot) with unique slots, a random tail of (+inf, -1)
    padding and random visited flags; E*R candidates over a slot range that
    overlaps the beam, so that some are in the beam, some repeat another
    node's candidate at another distance (E > 1), some hit a seed (visited
    or not) and some are not live. Distances are multiples of 1/8, so many
    tie; ``special`` draws them from -0.0, +0.0, +-inf, NaN and ties."""
    C = E * R
    hi = 2 * (L + C)

    def dists(shape):
        if special:
            return rng.choice(SPECIAL, shape)
        return (np.round(rng.random(shape) * 8) / 8).astype(np.float32)

    slot = np.argsort(rng.random((B, hi)), axis=1)[:, :L].astype(np.int32)
    dist = dists((B, L))
    order = np.lexsort((slot, dist), axis=-1)
    slot = np.take_along_axis(slot, order, -1)
    dist = np.take_along_axis(dist, order, -1)
    pad = np.arange(L)[None, :] >= rng.integers(0, L + 1, (B, 1))
    dist[pad], slot[pad] = INF, -1
    vis = (rng.random((B, L)) < 0.4) & ~pad

    nbrs = rng.integers(-1, hi, (B, E, R)).astype(np.int32)
    if E > 1:  # node e repeats part of node 0's row
        nbrs[:, 1:, : R // 2] = nbrs[:, :1, : R // 2]
    from_beam = rng.random((B, E, R)) < 0.2
    nbrs[from_beam] = slot[:, :1].repeat(E * R, 1).reshape(B, E, R)[from_beam]
    seeds = rng.integers(0, hi, (B, S)).astype(np.int32)
    from_seed = rng.random((B, E, R)) < 0.1
    nbrs[from_seed] = seeds[:, :1].repeat(E * R, 1).reshape(B, E, R)[from_seed]
    live = (nbrs >= 0) & (rng.random((B, E, R)) < 0.9)
    return (dist, slot, vis, nbrs, dists((B, E, R)), live, seeds,
            rng.random((B, S)) < 0.5)


def _dist_order(d):
    return (1, 0.0) if np.isnan(d) else (0, float(d))


def oracle(beam_dist, beam_slot, beam_vis, nbrs, edge_dist, live, seeds,
           seed_vis):
    """The merge, lane by lane, by Python's stable tuple sort."""
    B, L = beam_slot.shape
    E = nbrs.shape[1]
    out = (beam_dist.copy(), beam_slot.copy(), beam_vis.copy())
    for b in range(B):
        in_beam = {int(s) for s in beam_slot[b] if s >= 0}
        vis_seed = {int(s) for s, v in zip(seeds[b], seed_vis[b]) if v}
        ents = list(zip(beam_dist[b], beam_slot[b].tolist(),
                        beam_vis[b].tolist()))
        for s, d, ok in zip(nbrs[b].ravel().tolist(), edge_dist[b].ravel(),
                            live[b].ravel().tolist()):
            ok = ok and s not in in_beam and s not in vis_seed
            ents.append((d, s, False) if ok else (INF, -1, False))
        if E > 1:
            ents.sort(key=lambda e: (e[1], _dist_order(e[0])))
            seen = set()
            for i, (d, s, v) in enumerate(ents):
                if s >= 0 and s in seen:
                    ents[i] = (INF, -1, v)
                seen.add(s)
        ents.sort(key=lambda e: (_dist_order(e[0]), e[1]))
        for i, (d, s, v) in enumerate(ents[:L]):
            out[0][b, i] = d
            out[1][b, i] = -1 if np.isinf(d) else s
            out[2][b, i] = v
    return out


def _lanes_then(rng, edit, **shape):
    args = random_lanes(rng, **shape)
    edit(*args)
    return args


def _equal_dists(bd, bs, bv, nbrs, ed, live, seeds, sv):
    bd[:, :] = np.where(np.isinf(bd), bd, 0.25)
    ed[...] = 0.25


def _signed_zeros(bd, bs, bv, nbrs, ed, live, seeds, sv):
    bd[:, :] = np.where(np.isinf(bd), bd, 0.0)
    bd[:, ::2] = np.where(np.isinf(bd[:, ::2]), bd[:, ::2], -0.0)
    ed[...] = np.float32(-0.0)
    ed[..., ::3] = 0.0


def _all_rejected(bd, bs, bv, nbrs, ed, live, seeds, sv):
    live[::2] = False  # half the lanes: no candidate is live
    for b in range(1, bs.shape[0], 2):  # the rest: all already in the beam
        real = bs[b][bs[b] >= 0]
        nbrs[b] = real[0] if len(real) else -1
        live[b] = len(real) > 0


def _inf_beam(bd, bs, bv, nbrs, ed, live, seeds, sv):
    bd[...], bs[...], bv[...] = INF, -1, False


def _in_beam(bd, bs, bv, nbrs, ed, live, seeds, sv):
    bd[:, 0], bs[:, 0] = 0.0, 10_000
    bd[:, 1:] = np.maximum(bd[:, 1:], 0.125)
    nbrs[:, :, :3] = 10_000  # already in the beam, at a better distance
    ed[:, :, :3] = -1.0
    live[:, :, :3] = True


def _visited_seed(bd, bs, bv, nbrs, ed, live, seeds, sv):
    seeds[:, 0], sv[:, 0] = 10_001, True  # visited: skipped
    seeds[:, 1], sv[:, 1] = 10_002, False  # not visited: kept
    nbrs[:, 0, :2] = (10_001, 10_002)
    live[:, 0, :2] = True


CASES = {
    "ties": lambda rng: _lanes_then(rng, _equal_dists, B=12, L=24, E=1,
                                    R=16, S=2),
    "signed_zero": lambda rng: _lanes_then(rng, _signed_zeros, B=12, L=24,
                                           E=1, R=16, S=2),
    "all_rejected": lambda rng: _lanes_then(rng, _all_rejected, B=8, L=16,
                                            E=1, R=8, S=1),
    "inf_beam": lambda rng: _lanes_then(rng, _inf_beam, B=8, L=16, E=1, R=8,
                                        S=1),
    "in_beam": lambda rng: _lanes_then(rng, _in_beam, B=8, L=16, E=1, R=8,
                                       S=1),
    "visited_seed": lambda rng: _lanes_then(rng, _visited_seed, B=8, L=16,
                                            E=1, R=8, S=3),
    "special_values": lambda rng: random_lanes(rng, B=16, L=20, E=1, R=12,
                                               S=2, special=True),
    "e2_repeats": lambda rng: random_lanes(rng, B=16, L=24, E=2, R=12, S=2),
    "e4_repeats": lambda rng: random_lanes(rng, B=12, L=24, E=4, R=8, S=3),
    "e4_special": lambda rng: random_lanes(rng, B=12, L=16, E=4, R=8, S=2,
                                           special=True),
    "fewer_than_l": lambda rng: random_lanes(rng, B=8, L=40, E=2, R=4, S=1),
}


def _hop_inputs(E):
    """The merge inputs of six real hops (``searcher._hop`` on random INT4
    tables of 1,024 rows, 4 lanes, L = 16), stacked along the lanes."""
    tables = profile_real.make_tables("cpu", cap_log2=10, b=4, l=16,
                                      n_queries=1)
    arrays, params, queries = tables
    B, L = 4, 16
    seeds = torch.tensor([3, 5, 9], dtype=torch.int32)
    seeds_b, sd, ss = searcher._seed_prefix(arrays, queries[0], seeds,
                                            params.metric, True)
    beam = list(searcher._pad_beam(sd, ss, L))
    beam.append(torch.zeros((B, L), dtype=torch.bool))
    seed_vis = torch.zeros(seeds_b.shape, dtype=torch.bool)
    seen = []

    def spy(*args):
        seen.append([a.clone() for a in args])
        return bm.beam_merge(*args)

    orig = searcher.beam_merge
    searcher.beam_merge = spy
    try:
        for _ in range(6):
            beam = list(searcher._hop(arrays, params, queries[0], None, *beam,
                                      seeds_b, seed_vis, E, True)[:3])
    finally:
        searcher.beam_merge = orig
    return tuple(torch.cat(parts).numpy() for parts in zip(*seen))


CASES["hop_states"] = lambda rng: _hop_inputs(1)
CASES["hop_states_e2"] = lambda rng: _hop_inputs(2)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", list(CASES))
def test_plain_merge_equals_the_tuple_sort_oracle(case):
    args = CASES[case](np.random.default_rng(sum(map(ord, case))))
    want = oracle(*args)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    before = bm.LAUNCHES
    got = bm.beam_merge(*tensors)
    assert bm.LAUNCHES == before  # the plain form counts no launch
    for name, g, t, w in zip(("beam_dist", "beam_slot", "beam_vis"), got,
                             tensors, want):
        assert g is t, f"{name} not written in place"
        assert torch.equal(_bits(g), _bits(torch.from_numpy(w))), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (B, L, E, R): the search cells' lanes (B 1,024 at L 100; 256 at L 128),
# the insert step's (1,024 at L 128), one lane of a short beam, and the
# widths E = 2 and 4.
CARD_SHAPES = [(1024, 100, 1, 64), (256, 128, 1, 64), (1024, 128, 1, 64),
               (1, 10, 1, 64), (2048, 128, 2, 64), (64, 128, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,e,r", CARD_SHAPES)
@pytest.mark.parametrize("special", [False, True])
def test_kernel_equals_plain_on_the_card(cuda_device, b, l, e, r, special):
    rng = np.random.default_rng(b * 1000 + l + e)
    args = random_lanes(rng, b, l, e, r, 3, special=special)
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    card = [t.to(cuda_device) for t in cpu]
    ptrs = [t.data_ptr() for t in card[:3]]
    before = bm.LAUNCHES
    got = bm.beam_merge(*card)
    torch.cuda.synchronize()
    assert bm.LAUNCHES == before + 1
    want = bm.beam_merge(*cpu)
    for name, g, t, p, w in zip(("beam_dist", "beam_slot", "beam_vis"), got,
                                card, ptrs, want):
        assert g is t and g.data_ptr() == p, f"{name} not written in place"
        assert torch.equal(_bits(g).cpu(), _bits(w)), name
