"""PyTorch port ops against the JAX package: distance, INT8/INT4 codes,
ternary planes and dots, top-k.

Inputs are made with numpy from the ``rng`` fixture and handed to both
sides; each side gets its own enum members (``tests/torch_configs.py``).
Tolerances: distances rtol 1e-5 (f32 summation order differs between XLA
and torch); codes, planes, integer dots and sort results exact; INT8 scales
rtol 1e-6 (max|v| / 127: a last-bit difference where XLA multiplies by a
rounded 1/127).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.ops import distance as jdist
from duckdb_lm_diskann_tpu.ops import quantize as jq
from duckdb_lm_diskann_tpu.ops import ternary as jtern
from duckdb_lm_diskann_tpu.ops import topk as jtopk
from duckdb_lm_diskann_tpu_torch.ops import distance as tdist
from duckdb_lm_diskann_tpu_torch.ops import quantize as tq
from duckdb_lm_diskann_tpu_torch.ops import ternary as ttern
from duckdb_lm_diskann_tpu_torch.ops import topk as ttopk
from duckdb_lm_diskann_tpu_torch.common.types import MetricType
from tests.torch_configs import metrics
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

METRICS = [MetricType.L2, MetricType.IP, MetricType.COSINE]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches_jax(rng, metric):
    jmetric, metric = metrics(metric.value)
    a = rng.standard_normal((6, 5, 24)).astype(np.float32)
    b = rng.standard_normal((6, 5, 24)).astype(np.float32)
    a[0, 0] = 0.0  # zero vectors: cosine -> 1.0
    b[1, 2] = 0.0
    got = tdist.pairwise_distance(_t(a), _t(b), metric)
    want = jdist.pairwise_distance(jnp.asarray(a), jnp.asarray(b), jmetric)
    _close(got, want)
    # Broadcast form used by the searcher: [B, 1, D] x [B, R, D].
    got = tdist.pairwise_distance(_t(a[:, :1]), _t(b), metric)
    want = jdist.pairwise_distance(jnp.asarray(a[:, :1]), jnp.asarray(b), jmetric)
    _close(got, want)
    if metric is MetricType.COSINE:
        assert float(got[1, 2]) == 1.0


@pytest.mark.parametrize("metric", METRICS)
def test_all_pairs_distance_matches_jax(rng, metric):
    jmetric, metric = metrics(metric.value)
    q = rng.standard_normal((7, 20)).astype(np.float32)
    base = rng.standard_normal((33, 20)).astype(np.float32)
    base[3] = 0.0
    got = tdist.all_pairs_distance(_t(q), _t(base), metric)
    want = jdist.all_pairs_distance(jnp.asarray(q), jnp.asarray(base), jmetric)
    _close(got, want, atol=1e-5)
    vecs = rng.standard_normal((3, 9, 20)).astype(np.float32)
    vecs[1, 4] = 0.0
    got = tdist.batched_all_pairs_distance(_t(vecs), metric).numpy()
    want = np.asarray(
        jdist.batched_all_pairs_distance(jnp.asarray(vecs), jmetric)
    )
    off = ~np.eye(9, dtype=bool)[None].repeat(3, 0)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-5)
    # The diagonal is the distance of a vector to itself: in the product
    # form that is sqrt(|v|^2 + |v|^2 - 2 v.v), a cancelled ~0 sum whose
    # sqrt amplifies f32 rounding. Both sides must be near 0.
    diag = ~off
    tol = 1e-2 if metric is MetricType.L2 else 1e-5
    np.testing.assert_allclose(got[diag], want[diag], atol=tol)


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
def test_similarity_to_distance_matches_jax(metric):
    """IP -> -sim, COSINE -> 1 - sim on the raw integer dot, L2 refused."""
    jmetric, metric = metrics(metric)
    sim = np.array([[-960, -3, 0, 1, 7, 960]], np.int32)
    if metric.value == "l2":
        with pytest.raises(ValueError, match="L2"):
            tdist.similarity_to_distance(_t(sim).float(), metric)
        return
    got = tdist.similarity_to_distance(_t(sim).float(), metric)
    want = jdist.similarity_to_distance(
        jnp.asarray(sim).astype(jnp.float32), jmetric
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ternary_inputs(rng, d):
    """Vectors with exact zeros (neither plane) and, for D >= 32, sign
    patterns that set bit 31 of a word."""
    v = rng.standard_normal((4, 6, d)).astype(np.float32)
    v[0, 0] = 0.0
    v[1, 1, ::3] = 0.0
    v[2, 2, 31::32] = -1.0  # bit 31 of every word in the negative plane
    v[2, 3, 31::32] = 1.0  # ... and in the positive plane
    return v


@pytest.mark.parametrize("d", [64, 100, 960])
def test_ternary_planes_and_dot_match_jax(rng, d):
    v = _ternary_inputs(rng, d)
    pos, neg = ttern.encode_ternary(_t(v))
    j_pos, j_neg = jtern.encode_ternary(jnp.asarray(v))
    assert pos.dtype == torch.int32 and pos.shape[-1] == 2 * ((d + 63) // 64)
    np.testing.assert_array_equal(pos.numpy().view(np.uint32), np.asarray(j_pos))
    np.testing.assert_array_equal(neg.numpy().view(np.uint32), np.asarray(j_neg))
    # The sign bit was set in every word whose bit 31 is a dimension.
    assert (np.asarray(j_neg)[2, 2, : d // 32] >> 31).all()
    n_pos, n_neg = ttern.encode_ternary_np(v)
    np.testing.assert_array_equal(n_pos, np.asarray(j_pos))
    np.testing.assert_array_equal(n_neg, np.asarray(j_neg))

    # Dots of every (query, row) pair: the query planes broadcast.
    q = rng.standard_normal((4, d)).astype(np.float32)
    q[1] = 0.0
    qp, qn = ttern.encode_ternary(_t(q))
    jqp, jqn = jtern.encode_ternary(jnp.asarray(q))
    got = ttern.ternary_dot(qp[:, None, :], qn[:, None, :], pos, neg)
    want = jtern.ternary_dot(jqp[:, None, :], jqn[:, None, :], j_pos, j_neg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(),
        jtern.ternary_dot_np(
            np.asarray(jqp)[:, None, :], np.asarray(jqn)[:, None, :],
            np.asarray(j_pos), np.asarray(j_neg),
        ),
    )
    np.testing.assert_array_equal(
        ttern.ternary_dot_np(n_pos[:, :1], n_neg[:, :1], n_pos, n_neg),
        jtern.ternary_dot_np(n_pos[:, :1], n_neg[:, :1], n_pos, n_neg),
    )
    sim = ttern.ternary_similarity(_t(q), pos, neg)
    j_sim = jtern.ternary_similarity(jnp.asarray(q), j_pos, j_neg)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(j_sim))


def test_popcount_covers_every_bit():
    words = torch.tensor(
        [0, -1, 1, -(2**31), 2**31 - 1, 0x55555555, -0x55555556],
        dtype=torch.int32,
    )
    want = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words.tolist()]
    assert ttern.popcount32(words).tolist() == want


@pytest.mark.parametrize("d", [64, 100, 960])
def test_int8_codes_match_jax(rng, d):
    v = 3.0 * rng.standard_normal((4, 6, d)).astype(np.float32)
    v[0, 0] = 0.0  # zero vector: scale 0, zero codes
    codes, scale = tq.encode_int8(_t(v))
    j_codes, j_scale = jq.encode_int8(jnp.asarray(v))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), rtol=1e-6)
    assert int(codes.abs().max()) == 127 and float(scale[0, 0]) == 0.0
    np.testing.assert_allclose(
        tq.decode_int8(codes, scale).numpy(),
        np.asarray(jq.decode_int8(j_codes, j_scale)), rtol=1e-6,
    )
    n_codes, n_scale = tq.encode_int8_np(v)
    w_codes, w_scale = jq.encode_int8_np(v)
    np.testing.assert_array_equal(n_codes, w_codes)
    np.testing.assert_array_equal(n_scale, w_scale)
    np.testing.assert_array_equal(
        tq.decode_int8_np(n_codes, n_scale), jq.decode_int8_np(w_codes, w_scale)
    )


@pytest.mark.parametrize("d", [32, 40, 100])
def test_int4_codes_match_jax(rng, d):
    v = rng.standard_normal((4, 6, d)).astype(np.float32)
    v[0, 0] = 0.0  # zero vector: scale 0, zero codes
    words, scale = tq.encode_int4(_t(v))
    j_words, j_scale = jq.encode_int4(jnp.asarray(v))
    assert tq.words_per_i4(d) == jq.words_per_i4(d) == words.shape[-1]
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32), np.asarray(j_words)
    )
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(
        tq.unpack_int4(words, d).numpy(),
        np.asarray(jq.unpack_int4(j_words, d)),
    )
    np.testing.assert_array_equal(
        tq.decode_int4(words, scale, d).numpy(),
        np.asarray(jq.decode_int4(j_words, j_scale, d)),
    )


@pytest.mark.parametrize("d", [32, 40, 101])
def test_int4_numpy_helpers_match_jax(rng, d):
    v = rng.standard_normal((5, d)).astype(np.float32)
    packed, scale = tq.encode_int4_np(v)
    j_packed, j_scale = jq.encode_int4_np(v)
    np.testing.assert_array_equal(packed, j_packed)
    np.testing.assert_array_equal(scale, j_scale)
    planar = tq.i4_planar_from_packed_np(packed, d)
    np.testing.assert_array_equal(planar, jq.i4_planar_from_packed_np(packed, d))
    np.testing.assert_array_equal(
        tq.i4_packed_from_planar_np(planar.view(np.int32), d), packed
    )
    # The device encoder and the host packer agree through the converter.
    words, _ = tq.encode_int4(_t(v))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), planar)


@pytest.mark.parametrize("d", [1, 7, 8, 9, 15, 100, 128, 129])
def test_int4_layout_converters_match_jax_on_any_bits(rng, d):
    """The port's byte-wise converters against the JAX package's 32-bit
    loops, on every bit pattern (not only encoder output) and two leading
    shapes; int32 words convert as their uint32 bits."""
    for lead in ((6,), (3, 5)):
        packed = rng.integers(0, 256, lead + ((d + 1) // 2,)).astype(np.uint8)
        np.testing.assert_array_equal(
            tq.i4_planar_from_packed_np(packed, d),
            jq.i4_planar_from_packed_np(packed, d),
        )
        words = rng.integers(0, 2**32, lead + ((d + 7) // 8,), dtype=np.uint64)
        words = words.astype(np.uint32)
        want = jq.i4_packed_from_planar_np(words, d)
        for w in (words, words.view(np.int32)):
            np.testing.assert_array_equal(tq.i4_packed_from_planar_np(w, d), want)


def _ties_and_pads(rng, shape, n_ids):
    """Distances on a coarse grid (many exact ties), ids with duplicates,
    and (+inf, -1) pads."""
    dist = rng.integers(0, 6, shape).astype(np.float32) / 4.0
    ids = rng.integers(0, n_ids, shape).astype(np.int32)
    pad = rng.random(shape) < 0.2
    dist[pad] = np.inf
    ids[pad] = -1
    return dist, ids


def test_sort_and_dedup_match_jax(rng):
    dist, ids = _ties_and_pads(rng, (8, 40), 25)
    extra = np.arange(8 * 40, dtype=np.int32).reshape(8, 40)
    got = ttopk.sort_by_distance_id(_t(dist), _t(ids), _t(extra))
    want = jtopk.sort_by_distance_id(
        jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(extra)
    )
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = ttopk.dedup_sorted_ids(got[0], got[1])
    want = jtopk.dedup_sorted_ids(want[0], want[1])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for bitonic in (False, True):
        # jit: one compile instead of one per op of the bitonic network.
        want = jax.jit(
            functools.partial(jtopk.sorted_dedup_topk, bitonic=bitonic)
        )(jnp.asarray(dist), jnp.asarray(ids))
        got = ttopk.sorted_dedup_topk(_t(dist), _t(ids))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m_d, m_i = ttopk.mask_invalid(_t(dist), _t(ids), _t(ids % 3 == 0))
    w_d, w_i = jtopk.mask_invalid(
        jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(ids % 3 == 0)
    )
    np.testing.assert_array_equal(m_d.numpy(), np.asarray(w_d))
    np.testing.assert_array_equal(m_i.numpy(), np.asarray(w_i))


def test_signed_zero_ties_follow_the_oracle():
    """-0.0 and +0.0 tie and resolve by id, as the NumPy oracle's tuple
    sort does (an IP distance of an exactly-zero dot is -0.0)."""
    dist = torch.tensor([[0.0, -0.0, 0.0]])
    ids = torch.tensor([[5, 3, 4]], dtype=torch.int32)
    _, s = ttopk.sort_by_distance_id(dist, ids)
    want = [i for _, i in sorted(zip([0.0, -0.0, 0.0], [5, 3, 4]))]
    assert s.tolist()[0] == want == [3, 4, 5]


def test_merge_beams_matches_jax(rng):
    """The E=1 hop shape (sorted beam, disjoint candidates) and the dedup
    merge, against both JAX implementations."""
    B, L, R = 6, 16, 8
    beam_d, beam_i = _ties_and_pads(rng, (B, L), 1000)
    beam_i = np.where(beam_i >= 0, np.arange(L, dtype=np.int32)[None] * 3, -1)
    beam_d, beam_i = (np.asarray(x) for x in jtopk.sort_by_distance_id(
        jnp.asarray(beam_d), jnp.asarray(beam_i)))
    beam_v = (rng.random((B, L)) < 0.5) & (beam_i >= 0)
    cand_d, cand_i = _ties_and_pads(rng, (B, R), 1000)
    cand_i = np.where(cand_i >= 0, 3 * np.arange(R, dtype=np.int32) + 1, -1)
    cand_i = cand_i.astype(np.int32)
    zeros = np.zeros((B, R), bool)
    got = ttopk.merge_beams(
        _t(beam_d), _t(beam_i), _t(cand_d), _t(cand_i), L,
        extras_a=(_t(beam_v),), extras_b=(_t(zeros),),
    )
    for bitonic in (False, True):
        want = jax.jit(functools.partial(
            jtopk.merge_beams, size=L, a_sorted=True, bitonic=bitonic,
        ))(
            jnp.asarray(beam_d), jnp.asarray(beam_i),
            jnp.asarray(cand_d), jnp.asarray(cand_i),
            extras_a=(jnp.asarray(beam_v.astype(np.int32)),),
            extras_b=(jnp.asarray(zeros.astype(np.int32)),),
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(
            got[2].numpy(), np.asarray(want[2]).astype(bool)
        )

    # dedup: the two sides share ids, with differing distances.
    a_d, a_i = _ties_and_pads(rng, (B, 12), 10)
    b_d, b_i = _ties_and_pads(rng, (B, 12), 10)
    ex_a = np.arange(B * 12, dtype=np.int32).reshape(B, 12)
    ex_b = ex_a + 1000
    got = ttopk.merge_beams(
        _t(a_d), _t(a_i), _t(b_d), _t(b_i), 10,
        extras_a=(_t(ex_a),), extras_b=(_t(ex_b),), dedup=True,
    )
    for bitonic in (False, True):
        want = jax.jit(functools.partial(
            jtopk.merge_beams, size=10, dedup=True, bitonic=bitonic,
        ))(
            jnp.asarray(a_d), jnp.asarray(a_i), jnp.asarray(b_d),
            jnp.asarray(b_i), extras_a=(jnp.asarray(ex_a),),
            extras_b=(jnp.asarray(ex_b),),
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        if not bitonic:  # bitonic networks are not stable for the extras
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("metric", METRICS)
def test_query_to_neighbors_distance_matches_jax(rng, metric):
    """query [B, D] against each query's own R neighbor vectors [B, R, D],
    zero vectors included (cosine -> 1.0)."""
    jmetric, metric = metrics(metric.value)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    nb = rng.standard_normal((6, 9, 24)).astype(np.float32)
    q[2] = 0.0
    nb[1, 4] = 0.0
    got = tdist.query_to_neighbors_distance(_t(q), _t(nb), metric)
    want = jdist.query_to_neighbors_distance(
        jnp.asarray(q), jnp.asarray(nb), jmetric)
    assert tuple(got.shape) == (6, 9)
    _close(got, want)


@pytest.mark.parametrize("d", [1, 7, 8, 32, 101, 128])
def test_decode_int4_np_matches_jax(rng, d):
    """The packed byte format on every bit pattern (both nibbles' sign
    extension), odd D dropping the pad nibble; exact."""
    packed = rng.integers(0, 256, (5, 3, (d + 1) // 2)).astype(np.uint8)
    scales = rng.random((5, 3)).astype(np.float32)
    got = tq.decode_int4_np(packed, scales, d)
    want = jq.decode_int4_np(packed, scales, d)
    assert got.shape == (5, 3, d) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Round trip through the planar words of the device layout.
    v = rng.standard_normal((4, d)).astype(np.float32)
    words, scale = tq.encode_int4(_t(v))
    back = tq.decode_int4_np(
        tq.i4_packed_from_planar_np(words.numpy(), d), scale.numpy(), d)
    np.testing.assert_array_equal(
        back, tq.decode_int4(words, scale, d).numpy())


@pytest.mark.parametrize("k", [1, 5, 40])
def test_topk_by_distance_matches_jax_and_a_lexsort(rng, k):
    """Exact ties on a coarse grid, duplicate ids and (+inf, -1) pads, no
    signed zeros (lax.sort orders -0.0 before +0.0)."""
    dist, ids = _ties_and_pads(rng, (8, 40), 25)
    got_d, got_i = ttopk.topk_by_distance(_t(dist), _t(ids), k)
    want_d, want_i = jtopk.topk_by_distance(jnp.asarray(dist), jnp.asarray(ids), k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    order = np.stack([np.lexsort((i, d)) for d, i in zip(dist, ids)])[:, :k]
    np.testing.assert_array_equal(got_d.numpy(), np.take_along_axis(dist, order, 1))
    np.testing.assert_array_equal(got_i.numpy(), np.take_along_axis(ids, order, 1))


def test_topk_by_distance_ties_signed_zeros_by_id():
    dist = torch.tensor([[0.0, -0.0, 0.5, 0.0]])
    ids = torch.tensor([[5, 3, 1, 4]], dtype=torch.int32)
    d, i = ttopk.topk_by_distance(dist, ids, 3)
    assert i.tolist() == [[3, 4, 5]] and d.tolist() == [[0.0, 0.0, 0.0]]
