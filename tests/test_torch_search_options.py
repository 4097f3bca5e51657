"""Every ``Coordinator.search`` option of the PyTorch port against the JAX
Coordinator, on one graph built by JAX and carried across (arrays, the
rowid<->slot maps and the entry point; rowids differ from slots).

Same queries, same options: identical rowids, distances to rtol 1e-5, and
the same ``last_search_stats`` hop and visit counts (on the pipelined
``batch_size`` path: hops over every batch, pad lanes included, visits over
the real lanes only).
"""

import numpy as np
import pytest

from duckdb_lm_diskann_tpu.core.coordinator import Coordinator as JaxCoordinator
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import graph_arrays_from_numpy
from tests.torch_configs import configs
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

N, DIMS, NQ = 400, 16, 12
ROWIDS = np.arange(N, dtype=np.int64) * 3 + 1000


def carry_across(jax_coord, port_cfg) -> Coordinator:
    """A port Coordinator holding the JAX Coordinator's index."""
    port = Coordinator(port_cfg, initial_capacity=jax_coord.capacity,
                       device="cpu")
    port.arrays = graph_arrays_from_numpy(jax_coord.arrays, "cpu")
    port.allocator.rowid_to_slot = dict(jax_coord.allocator.rowid_to_slot)
    port.allocator.slot_to_rowid = dict(jax_coord.allocator.slot_to_rowid)
    port.allocator.high_water = jax_coord.allocator.high_water
    port.entry_slot = jax_coord.entry_slot
    port.entry_rowid = jax_coord.entry_rowid
    port._slot_rowids = np.array(jax_coord._slot_rowids)
    return port


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(0xC0)
    jax_cfg, port_cfg = configs(dims=DIMS)
    centers = 3.0 * rng.standard_normal((8, DIMS)).astype(np.float32)
    data = centers[rng.integers(0, 8, N)] + rng.standard_normal(
        (N, DIMS)
    ).astype(np.float32)
    jc = JaxCoordinator(jax_cfg, initial_capacity=N)
    jc.bulk_build(ROWIDS.tolist(), data, max_batch=64)
    queries = data[rng.integers(0, N, NQ)] + 0.05 * rng.standard_normal(
        (NQ, DIMS)
    ).astype(np.float32)
    return jc, carry_across(jc, port_cfg), queries


def _assert_same(port, jc, got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    ps, js = port.last_search_stats, jc.last_search_stats
    assert (ps.queries, ps.hops, ps.nodes_visited, ps.distance_ops) == (
        js.queries, js.hops, js.nodes_visited, js.distance_ops
    )


def test_positional_beam_width_matches_jax(coords):
    """search(q, k, L, 2): the fourth positional parameter is beam_width on
    both sides (the port once took it as n_seeds)."""
    jc, port, q = coords
    got = port.search(q, 10, 32, 2)
    want = jc.search(q, 10, 32, 2)
    _assert_same(port, jc, got, want)
    assert (got[0] >= 1000).all()  # rowids, not slots
    port.search(q, 10, 32)
    assert port.last_search_stats.hops > jc.last_search_stats.hops  # E=1


ALLOWED = ROWIDS[::4]
OPTIONS = {
    "n_seeds": dict(n_seeds=3),
    "allowed": dict(allowed_rowids=ALLOWED),
    "batch": dict(batch_size=5),
    "batch-E2-allowed": dict(batch_size=5, beam_width=2,
                             allowed_rowids=ALLOWED),
    "adaptive": dict(adaptive_seeds=2, seed_sample=64),
    "adaptive-batch": dict(adaptive_seeds=2, seed_sample=64, batch_size=5),
    "stream": dict(stream=True, lanes=4),
    "stream-adaptive": dict(stream=True, lanes=8, adaptive_seeds=2,
                            seed_sample=64),
    "stream-allowed-batch": dict(stream=True, lanes=4, batch_size=5,
                                 allowed_rowids=ALLOWED),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_search_option_matches_jax(coords, name):
    jc, port, q = coords
    opts = OPTIONS[name]
    got = port.search(q, 8, 24, **opts)
    want = jc.search(q, 8, 24, **opts)
    _assert_same(port, jc, got, want)
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
    jc, port, q = coords
    got = port.search(q, 5, view=port.capture_view(3))
    want = jc.search(q, 5, view=jc.capture_view(3))
    _assert_same(port, jc, got, want)
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
    _, port, q = coords
    jax_cfg, port_cfg = configs(dims=DIMS)
    got = Coordinator(port_cfg, device="cpu").search(
        q, 3, beam_width=2, stream=True
    )
    want = JaxCoordinator(jax_cfg).search(q, 3, beam_width=2, stream=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert (got[0] == -1).all() and np.isinf(got[1]).all()
    with pytest.raises(ValueError, match="beam_width=1"):
        port.search(q, 3, beam_width=2, stream=True)
