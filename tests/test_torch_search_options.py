"""Every ``Coordinator.search`` option of the PyTorch port against the JAX
Coordinator, on one graph built by JAX and carried across (arrays, the
rowid<->slot maps and the entry point; rowids differ from slots).

Same queries, same options: identical rowids, distances to rtol 1e-5, and
the same ``last_search_stats`` hop and visit counts (on the pipelined
``batch_size`` path: hops over every batch, pad lanes included, visits over
the real lanes only).

The JAX side (its graph and every JAX answer with its stats) is recorded by
``tests/torch_record_search_options.py`` in
``tests/golden/torch_search_options_jax.npz``, so these tests run no JAX
program: a pytest worker that has compiled many JAX programs can crash
inside XLA's compile-cache read or write, and a test running there fails
with it.
"""

import types

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import graph_arrays_from_numpy
from tests import torch_record_search_options as rec
from tests.torch_configs import configs
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

N, DIMS, NQ = rec.N, rec.DIMS, rec.NQ
ROWIDS = rec.ROWIDS


def carry_across(jax_answers, port_cfg) -> Coordinator:
    """A port Coordinator holding the recorded JAX Coordinator's index."""
    port = Coordinator(port_cfg, initial_capacity=int(jax_answers["capacity"]),
                       device="cpu")
    graph = {f: jax_answers[f"graph/{f}"] for f in rec.GRAPH_FIELDS}
    port.arrays = graph_arrays_from_numpy(types.SimpleNamespace(**graph), "cpu")
    pairs = [(int(r), int(s)) for r, s in jax_answers["rowid_to_slot"]]
    port.allocator.rowid_to_slot = dict(pairs)
    port.allocator.slot_to_rowid = {s: r for r, s in pairs}
    port.allocator.high_water = int(jax_answers["high_water"])
    port.entry_slot = int(jax_answers["entry_slot"])
    port.entry_rowid = int(jax_answers["entry_rowid"])
    port._slot_rowids = jax_answers["slot_rowids"].copy()
    return port


@pytest.fixture(scope="module")
def jax_answers():
    with np.load(rec.OUT) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def coords(jax_answers):
    _, port_cfg = configs(dims=DIMS)
    return jax_answers, carry_across(jax_answers, port_cfg), jax_answers["queries"]


def recorded(jax_answers, prefix):
    """A recorded JAX answer: ((ids, dists), its last_search_stats)."""
    stats = types.SimpleNamespace(
        **{f: int(jax_answers[f"{prefix}/{f}"]) for f in rec.STATS}
    )
    return (jax_answers[f"{prefix}/ids"], jax_answers[f"{prefix}/dists"]), stats


def _assert_same(port, js, got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    ps = port.last_search_stats
    assert (ps.queries, ps.hops, ps.nodes_visited, ps.distance_ops) == (
        js.queries, js.hops, js.nodes_visited, js.distance_ops
    )


def test_positional_beam_width_matches_jax(coords):
    """search(q, k, L, 2): the fourth positional parameter is beam_width on
    both sides (the port once took it as n_seeds)."""
    ja, port, q = coords
    got = port.search(q, 10, 32, 2)
    want, js = recorded(ja, "positional")
    _assert_same(port, js, got, want)
    assert (got[0] >= 1000).all()  # rowids, not slots
    port.search(q, 10, 32)
    assert port.last_search_stats.hops > js.hops  # E=1


ALLOWED = rec.ALLOWED
OPTIONS = rec.OPTIONS


@pytest.mark.parametrize("name", list(OPTIONS))
def test_search_option_matches_jax(coords, name):
    ja, port, q = coords
    opts = OPTIONS[name]
    got = port.search(q, 8, 24, **opts)
    want, js = recorded(ja, f"option/{name}")
    _assert_same(port, js, got, want)
    if "allowed_rowids" in opts:
        assert np.isin(got[0][got[0] >= 0], ALLOWED).all()
    if opts.get("stream"):  # the lock-step path gives the same answers
        lock = {k: v for k, v in opts.items() if k not in ("stream", "lanes",
                                                           "batch_size")}
        ids, dists = port.search(q, 8, 24, **lock)
        np.testing.assert_array_equal(ids, got[0])
        np.testing.assert_array_equal(dists, got[1])


def test_view_and_errors(coords):
    """A captured ReadView is searched as the live index; stream search
    refuses E > 1; an empty index answers (-1, +inf)."""
    ja, port, q = coords
    got = port.search(q, 5, view=port.capture_view(3))
    want, js = recorded(ja, "view")
    _assert_same(port, js, got, want)
    np.testing.assert_array_equal(got[0], port.search(q, 5, n_seeds=3)[0])
    with pytest.raises(ValueError, match="beam_width=1"):
        port.search(q, 5, beam_width=2, stream=True)
    with pytest.raises(ValueError, match="batch_size"):
        port.search(q, 5, batch_size=0)
    empty = Coordinator(configs(dims=DIMS)[1], device="cpu")
    ids, d = empty.search(q, 3, stream=True, adaptive_seeds=2)
    assert (ids == -1).all() and np.isinf(d).all()


def test_empty_index_stream_search_with_beam_width_matches_jax(coords):
    """An empty index answers (-1, +inf) to a stream search of any
    beam_width, as the JAX Coordinator does; only a non-empty index refuses
    beam_width != 1 on the stream path."""
    ja, port, q = coords
    _, port_cfg = configs(dims=DIMS)
    got = Coordinator(port_cfg, device="cpu").search(
        q, 3, beam_width=2, stream=True
    )
    want = (ja["empty_stream/ids"], ja["empty_stream/dists"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert (got[0] == -1).all() and np.isinf(got[1]).all()
    with pytest.raises(ValueError, match="beam_width=1"):
        port.search(q, 3, beam_width=2, stream=True)
