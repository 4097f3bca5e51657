"""The serving path of the PyTorch port against the JAX package: beam search
at E = 2 and 4, ``beam_search_many``, ``pick_adaptive_seeds``, filtered
search and the batched build at ``insert_beam_width = 2``.

Each runs on the same inputs as its JAX counterpart. Graphs are built by
the JAX Coordinator once per module and carried across with
``graph_arrays_from_numpy``. Top-k slots, visit order, counts and hops must
be identical; distances agree to rtol 1e-5 (f32 summation order), with an
absolute floor of 1e-6 where a cosine distance nears 0 (TERNARY scores are
integers, so its ids, order and hops are exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.core import searcher as jax_searcher
from duckdb_lm_diskann_tpu.core.coordinator import Coordinator as JaxCoordinator
from duckdb_lm_diskann_tpu_torch.core import searcher
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import (
    GraphParams,
    graph_arrays_from_numpy,
)
from tests.torch_configs import configs, jax_graph, metrics
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

# (metric, codec) of the three ported codecs.
CODECS = ["l2-int4", "cosine-ternary", "l2-int8"]
N, DIMS = 300, 16


@pytest.fixture(scope="module")
def graphs():
    """codec name -> (JAX coordinator, carried-across arrays, port params,
    data, queries), each built once."""
    cache = {}

    def get(name):
        if name not in cache:
            coord, port_cfg, data, queries = jax_graph(
                *name.split("-"), n=N, dims=DIMS
            )
            cache[name] = (
                coord, graph_arrays_from_numpy(coord.arrays, "cpu"),
                GraphParams.from_config(port_cfg), data, queries,
            )
        return cache[name]

    return get


def atol_of(coord):
    return 1e-6 if coord.params.metric.value == "cosine" else 0.0


def assert_same_topk(got, want, atol):
    """Top-k slots, visit counts and hops identical; distances to rtol
    1e-5 (``atol`` for cosine)."""
    np.testing.assert_array_equal(
        got.topk_slots.numpy(), np.asarray(want.topk_slots)
    )
    np.testing.assert_allclose(
        got.topk_dists.numpy(), np.asarray(want.topk_dists), rtol=1e-5,
        atol=atol,
    )
    np.testing.assert_array_equal(
        got.visited_count.numpy(), np.asarray(want.visited_count)
    )
    np.testing.assert_array_equal(np.asarray(got.hops), np.asarray(want.hops))


def _same_search(got, want, atol):
    assert_same_topk(got, want, atol)
    np.testing.assert_array_equal(
        got.visited_slots.numpy(), np.asarray(want.visited_slots)
    )
    np.testing.assert_allclose(
        got.visited_dists.numpy(), np.asarray(want.visited_dists),
        rtol=1e-5, atol=atol,
    )


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("codec", CODECS)
def test_beam_width_matches_jax(graphs, codec, width):
    """E > 1: the E closest unvisited entries per hop, neighbors offered by
    two visited nodes merged once. E = 2 from the entry point; E = 4 from a
    seed set of four under a visit cap V = 30 that is no multiple of E, so
    the last hop's visits spill past V: dropped from the log, still
    counted."""
    coord, arrays, params, _, queries = graphs(codec)
    if width == 2:
        entry, max_visits = np.int32(coord.entry_slot), 0
    else:
        entry = np.asarray([coord.entry_slot, 17, 230, 99], np.int32)
        max_visits = 30
    kw = dict(l_search=32, k=10, max_visits=max_visits, beam_width=width,
              assume_all_valid=True)
    want = jax_searcher.beam_search(
        coord.arrays, jnp.asarray(queries), jnp.asarray(entry),
        params=coord.params, **kw,
    )
    got = searcher.beam_search(
        arrays, torch.from_numpy(queries), torch.from_numpy(np.array(entry)),
        params=params, **kw,
    )
    _same_search(got, want, atol_of(coord))
    for b in range(len(queries)):  # no slot visited twice
        vis = got.visited_slots[b][got.visited_slots[b] >= 0].tolist()
        assert len(vis) == len(set(vis))
    if max_visits:
        assert int(got.visited_count.max()) == 32  # 8 hops of 4 visits


@pytest.mark.parametrize("codec", CODECS)
def test_many_and_per_query_seeds_match_jax(graphs, codec):
    """beam_search_many equals JAX's and NB port beam_search calls, with
    shared seeds and with per-query seeds [NB, B, S]."""
    coord, arrays, params, _, queries = graphs(codec)
    qs = queries.reshape(3, 4, DIMS)
    per_query = np.random.default_rng(3).integers(0, N, (3, 4, 2)).astype(
        np.int32
    )
    per_query[0, :, 0] = coord.entry_slot
    kw = dict(l_search=24, k=5, assume_all_valid=True)
    for entry in (np.int32(coord.entry_slot), per_query):
        want = jax_searcher.beam_search_many(
            coord.arrays, jnp.asarray(qs), jnp.asarray(entry),
            params=coord.params, **kw,
        )
        got = searcher.beam_search_many(
            arrays, torch.from_numpy(qs), torch.from_numpy(np.array(entry)),
            params=params, **kw,
        )
        assert_same_topk(got, want, atol_of(coord))
        for nb in range(3):
            one = searcher.beam_search(
                arrays, torch.from_numpy(qs[nb]),
                torch.from_numpy(np.array(entry if entry.ndim == 0 else entry[nb])),
                params=params, **kw,
            )
            assert torch.equal(got.topk_slots[nb], one.topk_slots)
            assert torch.equal(got.topk_dists[nb], one.topk_dists)
            assert int(got.hops[nb]) == int(one.hops)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pick_adaptive_seeds_matches_jax(metric):
    """Per-query seeds from a sample that holds duplicate vectors: equal
    distances resolve to the lowest sample index, as lax.top_k does."""
    rng = np.random.default_rng(0xAD)
    jmetric, pmetric = metrics(metric)
    vecs = rng.standard_normal((N, DIMS)).astype(np.float32)
    vecs[3] = vecs[6] = vecs[0]  # exact ties in every query's list
    sample = np.arange(0, N, 3, dtype=np.int32)
    q = np.concatenate([
        rng.standard_normal((10, DIMS)).astype(np.float32), vecs[[0, 9]]
    ])
    for s_count in (1, 3):
        want = jax_searcher.pick_adaptive_seeds(
            jnp.asarray(vecs), jnp.asarray(q), jnp.asarray(sample),
            metric=jmetric, s_count=s_count,
        )
        got = searcher.pick_adaptive_seeds(
            torch.from_numpy(vecs), torch.from_numpy(q),
            torch.from_numpy(sample), metric=pmetric, s_count=s_count,
        )
        assert got.dtype == torch.int32 and got.shape == (len(q), s_count)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[-2].tolist() == [0, 3, 6]  # the tie, lowest index first


@pytest.mark.parametrize(
    "codec,width", [(c, 1) for c in CODECS] + [("l2-int4", 2)]
)
def test_filtered_search_matches_jax(graphs, codec, width):
    """``allowed`` filters the final top-k only: every result is allowed,
    and ids, visit order and hops equal JAX's."""
    coord, arrays, params, _, queries = graphs(codec)
    allowed = np.zeros(N, bool)
    allowed[::3] = True
    kw = dict(l_search=32, k=10, beam_width=width, assume_all_valid=True)
    want = jax_searcher.beam_search(
        coord.arrays, jnp.asarray(queries), jnp.int32(coord.entry_slot),
        params=coord.params, allowed=jnp.asarray(allowed), **kw,
    )
    got = searcher.beam_search(
        arrays, torch.from_numpy(queries), coord.entry_slot, params=params,
        allowed=torch.from_numpy(allowed), **kw,
    )
    _same_search(got, want, atol_of(coord))
    top = got.topk_slots.numpy()
    assert (top >= 0).any() and allowed[top[top >= 0]].all()


def test_insert_beam_width_build_matches_jax():
    """A batched build whose insert search visits two nodes a hop gives
    JAX's neighbor table, and its searches JAX's rowids."""
    rng = np.random.default_rng(0xB2)
    data = rng.standard_normal((400, DIMS)).astype(np.float32)
    jax_cfg, port_cfg = configs(dims=DIMS, insert_beam_width=2)
    jc = JaxCoordinator(jax_cfg, initial_capacity=len(data))
    jc.bulk_build(range(len(data)), data, max_batch=64)
    pc = Coordinator(port_cfg, initial_capacity=len(data), device="cpu")
    assert pc.params.insert_beam_width == 2
    pc.bulk_build(range(len(data)), data, max_batch=64)
    np.testing.assert_array_equal(
        pc.arrays.neighbors.numpy(), np.asarray(jc.arrays.neighbors)
    )
    q = data[:6] + 0.05
    np.testing.assert_array_equal(pc.search(q, 5)[0], jc.search(q, 5)[0])
