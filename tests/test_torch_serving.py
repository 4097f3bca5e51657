"""The serving path of the PyTorch port against the JAX package: beam search
at E = 2 and 4, ``beam_search_many``, ``pick_adaptive_seeds``, filtered
search and the batched build at ``insert_beam_width = 2``.

Each runs on the same inputs as its JAX counterpart. The JAX side (graphs
built by the JAX Coordinator from seeded data, carried across with
``graph_arrays_from_numpy``, and every JAX answer) is recorded by
``tests/torch_record_serving.py`` in ``tests/golden/torch_serving_jax.npz``,
so these tests run no JAX program: a pytest worker that has compiled many
JAX programs can crash inside XLA's compile-cache read or write, and a
test running there fails with it. Top-k slots, visit order, counts and
hops must be identical; distances agree to rtol 1e-5 (f32 summation
order), with an absolute floor of 1e-6 where a cosine distance nears 0
(TERNARY scores are integers, so its ids, order and hops are exact).
"""

import types

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import searcher
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import (
    GraphParams,
    graph_arrays_from_numpy,
)
from tests import torch_record_serving as rec
from tests.torch_configs import configs, metrics
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

# (metric, codec) of the three ported codecs.
CODECS = rec.CODECS
N, DIMS = rec.N, rec.DIMS


@pytest.fixture(scope="module")
def jax_answers():
    with np.load(rec.OUT) as f:
        return {k: f[k] for k in f.files}


def recorded(jax_answers, prefix, fields):
    """A recorded JAX result: its ``fields`` as attributes."""
    return types.SimpleNamespace(
        **{f: jax_answers[f"{prefix}/{f}"] for f in fields}
    )


@pytest.fixture(scope="module")
def graphs(jax_answers):
    """codec name -> (the JAX graph's entry point and metric, its arrays
    carried across, port params, data, queries)."""
    cache = {}

    def get(name):
        if name not in cache:
            metric, edge = name.split("-")
            port_cfg = configs(metric=metric, edge_type=edge, dims=DIMS)[1]
            g = recorded(jax_answers, f"graph/{name}", rec.GRAPH_FIELDS)
            coord = types.SimpleNamespace(
                entry_slot=int(jax_answers[f"graph/{name}/entry_slot"]),
                metric=metric,
            )
            cache[name] = (
                coord, graph_arrays_from_numpy(g, "cpu"),
                GraphParams.from_config(port_cfg), rec.graph_data(),
                jax_answers[f"graph/{name}/queries"],
            )
        return cache[name]

    return get


def atol_of(coord):
    return 1e-6 if coord.metric == "cosine" else 0.0


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
def test_beam_width_matches_jax(graphs, jax_answers, codec, width):
    """E > 1: the E closest unvisited entries per hop, neighbors offered by
    two visited nodes merged once. E = 2 from the entry point; E = 4 from a
    seed set of four under a visit cap V = 30 that is no multiple of E, so
    the last hop's visits spill past V: dropped from the log, still
    counted."""
    coord, arrays, params, _, queries = graphs(codec)
    entry, max_visits = rec.beam_entry(coord.entry_slot, width)
    kw = dict(l_search=32, k=10, max_visits=max_visits, beam_width=width,
              assume_all_valid=True)
    want = recorded(jax_answers, f"beam/{codec}/{width}", rec._SEARCH_FIELDS)
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
def test_many_and_per_query_seeds_match_jax(graphs, jax_answers, codec):
    """beam_search_many equals JAX's and NB port beam_search calls, with
    shared seeds and with per-query seeds [NB, B, S]."""
    coord, arrays, params, _, queries = graphs(codec)
    qs = queries.reshape(3, 4, DIMS)
    per_query = rec.per_query_seeds(coord.entry_slot)
    kw = dict(l_search=24, k=5, assume_all_valid=True)
    for i, entry in enumerate((np.int32(coord.entry_slot), per_query)):
        want = recorded(jax_answers, f"many/{codec}/{i}", rec._MANY_FIELDS)
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
def test_pick_adaptive_seeds_matches_jax(jax_answers, metric):
    """Per-query seeds from a sample that holds duplicate vectors: equal
    distances resolve to the lowest sample index, as lax.top_k does."""
    _, pmetric = metrics(metric)
    vecs, sample, q = rec.adaptive_inputs(metric)
    for s_count in (1, 3):
        want = jax_answers[f"adaptive/{metric}/{s_count}"]
        got = searcher.pick_adaptive_seeds(
            torch.from_numpy(vecs), torch.from_numpy(q),
            torch.from_numpy(sample), metric=pmetric, s_count=s_count,
        )
        assert got.dtype == torch.int32 and got.shape == (len(q), s_count)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[-2].tolist() == [0, 3, 6]  # the tie, lowest index first


@pytest.mark.parametrize("codec,width", rec.FILTER_CASES)
def test_filtered_search_matches_jax(graphs, jax_answers, codec, width):
    """``allowed`` filters the final top-k only: every result is allowed,
    and ids, visit order and hops equal JAX's."""
    coord, arrays, params, _, queries = graphs(codec)
    allowed = rec.filter_mask()
    kw = dict(l_search=32, k=10, beam_width=width, assume_all_valid=True)
    want = recorded(jax_answers, f"filter/{codec}/{width}", rec._SEARCH_FIELDS)
    got = searcher.beam_search(
        arrays, torch.from_numpy(queries), coord.entry_slot, params=params,
        allowed=torch.from_numpy(allowed), **kw,
    )
    _same_search(got, want, atol_of(coord))
    top = got.topk_slots.numpy()
    assert (top >= 0).any() and allowed[top[top >= 0]].all()


def test_insert_beam_width_build_matches_jax(jax_answers):
    """A batched build whose insert search visits two nodes a hop gives
    JAX's neighbor table, and its searches JAX's rowids."""
    data = rec.insert_width_data()
    _, port_cfg = configs(dims=DIMS, insert_beam_width=2)
    pc = Coordinator(port_cfg, initial_capacity=len(data), device="cpu")
    assert pc.params.insert_beam_width == 2
    pc.bulk_build(range(len(data)), data, max_batch=64)
    np.testing.assert_array_equal(
        pc.arrays.neighbors.numpy(), jax_answers["insert_width/neighbors"]
    )
    q = data[:6] + 0.05
    np.testing.assert_array_equal(
        pc.search(q, 5)[0], jax_answers["insert_width/search_ids"]
    )
