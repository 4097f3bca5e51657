"""The slice end to end: Coordinator.bulk_build + search, port vs JAX.

Same data, same queries: identical rowids, distances to rtol 1e-5 (f32
summation order). The ``cuda`` test runs the same slice on the card and
holds it against the CPU run; it skips without a card. JAX is imported
inside the test that uses it, so that the ``cuda`` test also runs where
only the port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType, VectorType
from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)


def _config(dims, edge_type=EdgeType.INT4):
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=12, l_insert=24, l_search=40,
        dimensions=dims, node_vector_type=VectorType.FLOAT32,
        edge_type=edge_type,
    )
    cfg.validate()
    return cfg


def _data(rng, n=1000, dims=24, nq=40):
    """Clustered vectors (as tests/test_build.py's clustered_data) and
    noisy queries near data points."""
    centers = rng.standard_normal((20, dims)).astype(np.float32)
    noise = 0.3 * rng.standard_normal((n, dims)).astype(np.float32)
    data = centers[rng.integers(0, 20, n)] + noise
    queries = data[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal(
        (nq, dims)
    ).astype(np.float32)
    return data, queries


def test_bulk_build_and_search_match_jax(rng):
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    data, queries = _data(rng)
    n, dims = data.shape
    rowids = [1000 + 3 * i for i in range(n)]  # rowids != slots
    jax_coord = JaxCoordinator(_config(dims), initial_capacity=n)
    jax_coord.bulk_build(rowids, data, max_batch=128)
    want_ids, want_d = jax_coord.search(queries, 10)

    port = Coordinator(_config(dims), initial_capacity=n)
    port.bulk_build(rowids, data, max_batch=128)
    got_ids, got_d = port.search(queries, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)
    stats = port.last_search_stats
    assert stats.queries == len(queries) and stats.nodes_visited > 0
    assert stats.hops == jax_coord.last_search_stats.hops
    assert stats.nodes_visited == jax_coord.last_search_stats.nodes_visited

    # Batches run one after another give the same answers, and an explicit
    # L_search below k is raised to k.
    b_ids, b_d = port.search(queries, 10, batch_size=16)
    np.testing.assert_array_equal(b_ids, got_ids)
    np.testing.assert_array_equal(b_d, got_d)
    j_ids, _ = jax_coord.search(queries[:5], 30, l_search=8, n_seeds=3)
    p_ids, _ = port.search(queries[:5], 30, l_search=8, n_seeds=3)
    np.testing.assert_array_equal(p_ids, j_ids)


def test_empty_index_and_capacity_growth(rng):
    port = Coordinator(_config(8), initial_capacity=10)
    assert port.capacity == 1024
    ids, d = port.search(np.zeros((2, 8), np.float32), 3)
    assert (ids == -1).all() and np.isinf(d).all()
    data = rng.standard_normal((1500, 8)).astype(np.float32)
    port.bulk_build(range(1500), data, max_batch=256)
    assert port.capacity == 2048 and port.count == 1500
    ids, _ = port.search(data[:4], 1)
    assert ids[:, 0].tolist() == [0, 1, 2, 3]


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="int8"):
        Coordinator(_config(8, EdgeType.INT8))


def test_cuda_coordinator_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Coordinator(_config(8), device="cuda")


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    data, queries = _data(np.random.default_rng(7), n=600)
    n, dims = data.shape
    cpu = Coordinator(_config(dims), initial_capacity=n)
    cpu.bulk_build(range(n), data, max_batch=128)
    want_ids, want_d = cpu.search(queries, 10)
    before = int4_frontier.LAUNCHES
    card = Coordinator(_config(dims), initial_capacity=n, device="cuda")
    card.bulk_build(range(n), data, max_batch=128)
    got_ids, got_d = card.search(queries, 10)
    assert int4_frontier.LAUNCHES > before
    # Kernel and plain scores differ in f32 summation order, so a near-tie
    # can flip an edge choice: hold recall and exactness, not identity.
    overlap = np.mean([
        len(set(a) & set(b)) / 10
        for a, b in zip(got_ids.tolist(), want_ids.tolist())
    ])
    assert overlap >= 0.95, overlap
    for b in range(len(queries)):
        for j in range(10):
            want = np.sqrt(((queries[b] - data[got_ids[b, j]]) ** 2).sum())
            assert abs(float(got_d[b, j]) - want) < 1e-4


def test_failed_insert_rolls_back(rng, monkeypatch):
    """A failed batch leaves the index as it was before the call: its rows
    are unmapped and out of the live mask; a failed bootstrap leaves no
    entry point; searches then pay the validity gather."""
    from duckdb_lm_diskann_tpu_torch.core import coordinator as coord_mod

    port = Coordinator(_config(8))
    data = rng.standard_normal((40, 8)).astype(np.float32)
    real = coord_mod.insert_batch
    calls = []

    def failing(arrays, slots, *args, **kwargs):
        calls.append(len(slots))
        if len(calls) == 3:
            raise RuntimeError("injected")
        return real(arrays, slots, *args, **kwargs)

    monkeypatch.setattr(coord_mod, "insert_batch", failing)
    with pytest.raises(RuntimeError, match="injected"):
        port.insert(range(40), data)
    assert port.count == 0 and port.entry_slot == -1
    assert not port.arrays.valid.any()
    assert port._ever_tombstoned

    monkeypatch.setattr(coord_mod, "insert_batch", real)
    port.insert(range(100, 140), data)
    assert port.count == 40
    ids, _ = port.search(data[:3], 1)
    assert ids[:, 0].tolist() == [100, 101, 102]
