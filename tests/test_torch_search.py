"""Beam search of the PyTorch port on graphs built by the JAX package.

A graph built by the JAX Coordinator is carried across with
``graph_arrays_from_numpy``; both engines then search it from the same
seeds. Top-k slots, the visit order and the visit counts must be identical,
distances equal to rtol 1e-5 (f32 summation order). At the shapes of
tests/oracle.py the visit order must equal the oracle's. The same holds for
graphs of the index's default codecs: TERNARY (cosine, integer scores, so
no tolerance on ids, order or hops) and INT8 (L2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
from duckdb_lm_diskann_tpu.core.coordinator import Coordinator as JaxCoordinator
from duckdb_lm_diskann_tpu.core.searcher import beam_search as jax_beam_search
from duckdb_lm_diskann_tpu_torch.core.graph import (
    GraphParams,
    graph_arrays_from_numpy,
)
from duckdb_lm_diskann_tpu_torch.core.searcher import (
    beam_search,
    search_for_initial_candidates,
)

from tests.oracle import OracleGraph
from tests.test_beam_search import make_params, oracle_to_arrays
from tests.torch_configs import configs
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

# (metric, codec) of the index's default codecs.
DEFAULT_CODECS = [("cosine", "ternary"), ("l2", "int8")]


def _configs(dims=16, metric="l2", edge="int4"):
    return configs(metric=metric, edge_type=edge, dims=dims)


def _config(dims=16):
    return _configs(dims)[1]


def _build_jax_graph(metric, edge, n=400, d=16):
    """A JAX-built graph, the port's config of it, and queries."""
    rng = np.random.default_rng(0x5EA2C)
    jax_cfg, port_cfg = _configs(d, metric, edge)
    data = rng.standard_normal((n, d)).astype(np.float32)
    coord = JaxCoordinator(jax_cfg, initial_capacity=512)
    coord.bulk_build(list(range(n)), data, max_batch=64)
    queries = data[rng.integers(0, n, 12)] + 0.05 * rng.standard_normal(
        (12, d)
    ).astype(np.float32)
    return coord, port_cfg, queries


@pytest.fixture(scope="module")
def jax_graph():
    coord, _, queries = _build_jax_graph("l2", "int4")
    return coord, queries


@pytest.fixture(scope="module", params=DEFAULT_CODECS, ids="-".join)
def codec_graph(request):
    return _build_jax_graph(*request.param, n=300)


def _assert_same_search(got, want, atol=0.0):
    np.testing.assert_array_equal(
        got.topk_slots.numpy(), np.asarray(want.topk_slots)
    )
    np.testing.assert_array_equal(
        got.visited_slots.numpy(), np.asarray(want.visited_slots)
    )
    np.testing.assert_array_equal(
        got.visited_count.numpy(), np.asarray(want.visited_count)
    )
    assert int(got.hops) == int(want.hops)
    for g, w in (
        (got.topk_dists, want.topk_dists),
        (got.visited_dists, want.visited_dists),
    ):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-5, atol=atol
        )


def test_graph_carries_across_and_back(jax_graph):
    coord, _ = jax_graph
    arrays = graph_arrays_from_numpy(coord.arrays, "cpu")
    assert arrays.edge_i4.dtype == torch.int32
    assert arrays.valid.dtype == torch.bool
    back = arrays.to_numpy()
    for name in arrays._fields:
        want = np.asarray(getattr(coord.arrays, name))
        got = getattr(back, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seeds", ["entry", "seed_set"])
def test_beam_search_matches_jax(jax_graph, seeds):
    coord, queries = jax_graph
    arrays = graph_arrays_from_numpy(coord.arrays, "cpu")
    params = GraphParams.from_config(_config())
    entry = (
        np.int32(coord.entry_slot)
        if seeds == "entry"
        else np.asarray([coord.entry_slot, 17, 230, 17], np.int32)
    )
    want = jax_beam_search(
        coord.arrays, jnp.asarray(queries), jnp.asarray(entry),
        params=coord.params, l_search=32, k=10, assume_all_valid=True,
    )
    got = beam_search(
        arrays, torch.from_numpy(queries), torch.from_numpy(np.array(entry)),
        params=params, l_search=32, k=10, assume_all_valid=True,
    )
    _assert_same_search(got, want)
    if seeds == "entry":
        # The validity gather changes nothing on a graph without tombstones.
        got2 = beam_search(
            arrays, torch.from_numpy(queries), int(coord.entry_slot),
            params=params, l_search=32, k=10,
        )
        _assert_same_search(got2, want)


def test_insert_candidate_search_matches_jax(jax_graph):
    from duckdb_lm_diskann_tpu.core.searcher import (
        search_for_initial_candidates as jax_candidates,
    )

    coord, queries = jax_graph
    arrays = graph_arrays_from_numpy(coord.arrays, "cpu")
    params = GraphParams.from_config(_config())
    want = jax_candidates(
        coord.arrays, jnp.asarray(queries), jnp.int32(coord.entry_slot),
        params=coord.params, l_insert=16,
    )
    got = search_for_initial_candidates(
        arrays, torch.from_numpy(queries), coord.entry_slot,
        params=params, l_insert=16,
    )
    assert got.visited_slots.shape[1] == 32  # 2 * L_insert visit budget
    _assert_same_search(got, want)


def test_codec_graph_carries_across_and_back(codec_graph):
    coord, _, _ = codec_graph
    arrays = graph_arrays_from_numpy(coord.arrays, "cpu")
    back = arrays.to_numpy()
    for name in arrays._fields:
        want = np.asarray(getattr(coord.arrays, name))
        got = getattr(back, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # The codec's own fields are the ones filled.
    filled = arrays.edge_pos if coord.params.edge_type is EdgeType.TERNARY \
        else arrays.edge_i8
    assert filled.shape[1:] == (8, filled.shape[2]) and filled.any()


@pytest.mark.parametrize("seeds", ["entry", "seed_set"])
def test_codec_beam_search_matches_jax(codec_graph, seeds):
    """TERNARY scores are integers: ids, visit order, counts and hops are
    identical; INT8 likewise, with distances to rtol 1e-5."""
    coord, port_cfg, queries = codec_graph
    arrays = graph_arrays_from_numpy(coord.arrays, "cpu")
    params = GraphParams.from_config(port_cfg)
    entry = (
        np.int32(coord.entry_slot)
        if seeds == "entry"
        else np.asarray([coord.entry_slot, 17, 230, 17], np.int32)
    )
    want = jax_beam_search(
        coord.arrays, jnp.asarray(queries), jnp.asarray(entry),
        params=coord.params, l_search=32, k=10, assume_all_valid=True,
    )
    got = beam_search(
        arrays, torch.from_numpy(queries), torch.from_numpy(np.array(entry)),
        params=params, l_search=32, k=10, assume_all_valid=True,
    )
    # A cosine distance is 1 - cos: near 0 its f32 rounding is absolute
    # (~1e-7, the rounding of cos ~ 1), so the exact distances get an
    # absolute floor of 1e-6 beside rtol 1e-5.
    _assert_same_search(got, want, atol=1e-6)


def _oracle_visit_order(rng, metric, edge):
    n, dims, k = 200, 16, 10
    jmetric, jedge = MetricType.parse(metric), EdgeType.parse(edge)
    jparams = make_params(jmetric, jedge, dims=dims)
    oracle = OracleGraph(dims, jparams.r, jmetric, jedge,
                         jparams.alpha, jparams.l_insert, jparams.l_search)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    oracle.build(range(n), data)
    arrays = graph_arrays_from_numpy(oracle_to_arrays(oracle, jparams), "cpu")
    params = GraphParams.from_config(_configs(dims, metric, edge)[1])
    queries = rng.standard_normal((8, dims)).astype(np.float32)
    res = beam_search(
        arrays, torch.from_numpy(queries), oracle.entry_point,
        params=params, l_search=params.l_search, k=k,
    )
    for b in range(len(queries)):
        want_ids, want_dists, visited, _ = oracle.search(queries[b], k)
        cnt = int(res.visited_count[b])
        assert res.visited_slots[b, :cnt].tolist() == visited
        assert res.topk_slots[b, : len(want_ids)].tolist() == want_ids
        np.testing.assert_allclose(
            res.topk_dists[b, : len(want_ids)].numpy(), want_dists,
            rtol=1e-5, atol=1e-6,
        )


def test_visit_order_matches_oracle(rng):
    """At tests/oracle.py's shapes: exact visit order and top-k."""
    _oracle_visit_order(rng, "l2", "int4")


@pytest.mark.parametrize("metric,edge", DEFAULT_CODECS + [("ip", "ternary")])
def test_codec_visit_order_matches_oracle(rng, metric, edge):
    _oracle_visit_order(rng, metric, edge)


def test_empty_graph_and_unported_paths(rng):
    from duckdb_lm_diskann_tpu_torch.core.graph import make_graph_arrays

    params = GraphParams.from_config(_config(8))
    arrays = make_graph_arrays(params, 16)
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    res = beam_search(arrays, q, -1, params=params, l_search=8, k=3)
    assert (res.topk_slots == -1).all() and torch.isinf(res.topk_dists).all()
    assert int(res.hops) == 0
    with pytest.raises(NotImplementedError, match="beam_width"):
        beam_search(arrays, q, 0, params=params, l_search=8, k=3, beam_width=2)
