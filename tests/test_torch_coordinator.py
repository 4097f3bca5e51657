"""The slice end to end: Coordinator.bulk_build + search, port vs JAX.

Same data, same queries: identical rowids, distances to rtol 1e-5 (f32
summation order). Every CPU test asks for ``device="cpu"``: the port's
default is the card. The ``cuda`` tests run the slice on the card and hold
it against the CPU run; they skip without a card. JAX is imported inside
the tests that use it, so that the ``cuda`` tests also run where only the
port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import (
    EdgeType,
    MetricType,
    VectorType,
)
from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import GraphParams
from duckdb_lm_diskann_tpu_torch.kernels import (
    int4_frontier,
    int8_frontier,
    ternary_frontier,
)
from duckdb_lm_diskann_tpu_torch.ops.distance import pairwise_distance
from tests.torch_configs import configs
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

# The default codec of each metric and the kernel that scores it.
DEFAULT_CODECS = {
    "cosine": (EdgeType.TERNARY, ternary_frontier),
    "l2": (EdgeType.INT8, int8_frontier),
}


def _configs(dims, edge_type="int4", metric="l2"):
    return configs(metric=metric, edge_type=edge_type, dims=dims, r=12,
                   l_insert=24, l_search=40)


def _config(dims, edge_type="int4", metric="l2"):
    return _configs(dims, edge_type, metric)[1]


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
    jax_cfg, port_cfg = _configs(dims)
    jax_coord = JaxCoordinator(jax_cfg, initial_capacity=n)
    jax_coord.bulk_build(rowids, data, max_batch=128)
    want_ids, want_d = jax_coord.search(queries, 10)

    port = Coordinator(port_cfg, initial_capacity=n, device="cpu")
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


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_default_codecs_match_jax(rng, metric):
    """``edge_type=None``: COSINE resolves to TERNARY and L2 to INT8 on both
    sides, and the slice gives the JAX package's rowids."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    data, queries = _data(rng, n=600)
    n, dims = data.shape
    rowids = [7 + 2 * i for i in range(n)]
    jax_cfg, port_cfg = _configs(dims, edge_type=None, metric=metric)
    jax_coord = JaxCoordinator(jax_cfg, initial_capacity=n)
    jax_coord.bulk_build(rowids, data, max_batch=128)
    want_ids, want_d = jax_coord.search(queries, 10)

    port = Coordinator(port_cfg, initial_capacity=n, device="cpu")
    assert port.params.edge_type is DEFAULT_CODECS[metric][0]
    assert jax_coord.params.edge_type.value == port.params.edge_type.value
    port.bulk_build(rowids, data, max_batch=128)
    got_ids, got_d = port.search(queries, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert port.last_search_stats.hops == jax_coord.last_search_stats.hops


def test_empty_index_and_capacity_growth(rng):
    port = Coordinator(_config(8), initial_capacity=10, device="cpu")
    assert port.capacity == 1024
    ids, d = port.search(np.zeros((2, 8), np.float32), 3)
    assert (ids == -1).all() and np.isinf(d).all()
    data = rng.standard_normal((1500, 8)).astype(np.float32)
    port.bulk_build(range(1500), data, max_batch=256)
    assert port.capacity == 2048 and port.count == 1500
    ids, _ = port.search(data[:4], 1)
    assert ids[:, 0].tolist() == [0, 1, 2, 3]


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="float1bit"):
        Coordinator(
            _config(8, "float1bit", metric="cosine"), device="cpu"
        )


def test_config_of_the_jax_package_is_refused():
    """The port compares its own enum members with ``is``: a JAX config or
    a JAX enum member must raise, never fall through."""
    from duckdb_lm_diskann_tpu.common.types import MetricType as JaxMetric

    jax_cfg, port_cfg = _configs(8)
    with pytest.raises(TypeError, match="LmDiskannConfig"):
        Coordinator(jax_cfg, device="cpu")
    with pytest.raises(TypeError, match="LmDiskannConfig"):
        GraphParams.from_config(jax_cfg)
    mixed = LmDiskannConfig(
        metric_type=JaxMetric.L2, r=8, l_insert=16, dimensions=8,
        node_vector_type=VectorType.FLOAT32,
    )
    with pytest.raises(TypeError, match="metric_type"):
        mixed.validate()
    assert GraphParams.from_config(port_cfg).metric is MetricType.L2


def test_default_device_is_the_card():
    """``Coordinator(config)`` puts the index on CUDA: without a card it
    raises, with one its tensors live there."""
    if torch.cuda.is_available():
        coord = Coordinator(_config(8))
        assert coord.device.type == "cuda"
        assert coord.arrays.vectors.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Coordinator(_config(8))


def test_cuda_coordinator_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Coordinator(_config(8), device="cuda")


def _hold_card_against_cpu(cfg, kernel, metric, data, queries):
    n = len(data)
    cpu = Coordinator(cfg, initial_capacity=n, device="cpu")
    cpu.bulk_build(range(n), data, max_batch=128)
    want_ids, _ = cpu.search(queries, 10)
    before = kernel.LAUNCHES
    card = Coordinator(cfg, initial_capacity=n)
    card.bulk_build(range(n), data, max_batch=128)
    mid = kernel.LAUNCHES
    got_ids, got_d = card.search(queries, 10)
    assert mid > before and kernel.LAUNCHES > mid
    # The card sums f32 distances in another order than the CPU (the INT4
    # and INT8 scores, and every codec's prune distances), so a near-tie can
    # flip an edge choice: hold recall and exactness, not identity.
    overlap = np.mean([
        len(set(a) & set(b)) / 10
        for a, b in zip(got_ids.tolist(), want_ids.tolist())
    ])
    assert overlap >= 0.95, overlap
    q = torch.from_numpy(queries).double()
    vecs = torch.from_numpy(data[got_ids]).double()
    exact = pairwise_distance(q[:, None, :], vecs, metric).numpy()
    np.testing.assert_allclose(got_d, exact, atol=1e-4)


@pytest.mark.cuda
def test_slice_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    data, queries = _data(np.random.default_rng(7), n=600)
    cfg = _config(data.shape[1])
    _hold_card_against_cpu(cfg, int4_frontier, MetricType.L2, data, queries)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_default_codecs_on_the_card_match_cpu(metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    data, queries = _data(np.random.default_rng(11), n=600)
    cfg = _config(data.shape[1], edge_type=None, metric=metric)
    _hold_card_against_cpu(
        cfg, DEFAULT_CODECS[metric][1], MetricType.parse(metric), data,
        queries,
    )


def test_failed_insert_rolls_back(rng, monkeypatch):
    """A failed batch leaves the index as it was before the call: its rows
    are unmapped and out of the live mask; a failed bootstrap leaves no
    entry point; searches then pay the validity gather."""
    from duckdb_lm_diskann_tpu_torch.core import coordinator as coord_mod

    port = Coordinator(_config(8), device="cpu")
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
