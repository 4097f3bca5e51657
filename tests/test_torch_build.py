"""Vamana build of the PyTorch port against the JAX package and the oracle.

Sequential (batch-1) inserts must give the JAX package's and the oracle's
neighbor lists; a batched bulk build must give the JAX package's neighbor
table, with edge codes (INT4 words, TERNARY planes, INT8 codes) equal and
scales equal to rtol 1e-6. (The scales are max|v| / 7 or / 127: the port
divides, while XLA's compiled JAX build multiplies by a rounded 1/7 or
1/127, so a scale can differ in its last bit.) Every test asks for
``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
from duckdb_lm_diskann_tpu.core.coordinator import Coordinator as JaxCoordinator
from duckdb_lm_diskann_tpu_torch.core.builder import (
    _rank_within_group,
    build_schedule,
)
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator

from tests.oracle import OracleGraph, brute_force_topk, exact_distance
from tests.test_build import clustered_data
from tests.torch_configs import configs
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

# (metric, codec) of the index's default codecs: TERNARY for cosine, INT8
# for L2.
DEFAULT_CODECS = [("cosine", "ternary"), ("l2", "int8")]
# Every field a codec writes: exact, except the scales (see the module
# docstring).
_CODE_FIELDS = ("edge_pos", "edge_neg", "edge_i8", "edge_i4")


def _configs(dims, r=8, l_insert=16, l_search=32, metric="l2", edge="int4"):
    return configs(metric=metric, edge_type=edge, dims=dims, r=r,
                   l_insert=l_insert, l_search=l_search)


def _config(dims, r=8, l_insert=16, l_search=32):
    return _configs(dims, r, l_insert, l_search)[1]


def _assert_same_graph(port: Coordinator, jax_coord: JaxCoordinator):
    got = port.arrays.to_numpy()
    for name in ("vectors", "neighbors", "valid", "dirty_rows") + _CODE_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name), np.asarray(getattr(jax_coord.arrays, name)),
            err_msg=name,
        )
    np.testing.assert_allclose(
        got.edge_scale, np.asarray(jax_coord.arrays.edge_scale), rtol=1e-6
    )
    assert port.entry_slot == jax_coord.entry_slot


def _sequential_build(rng, metric, edge, dims=10, n=80):
    jax_cfg, cfg = _configs(dims, metric=metric, edge=edge)
    port = Coordinator(cfg, initial_capacity=128, device="cpu")
    jax_coord = JaxCoordinator(jax_cfg, initial_capacity=128)
    oracle = OracleGraph(dims, cfg.r, MetricType.parse(metric),
                         EdgeType.parse(edge), cfg.alpha, cfg.l_insert,
                         cfg.l_search)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    for i in range(n):
        port.insert([i], data[i : i + 1])
        jax_coord.insert([i], data[i : i + 1])
        oracle.insert(i, data[i])
    _assert_same_graph(port, jax_coord)
    nbrs = port.arrays.neighbors.numpy()
    for i in range(n):
        got = [int(s) for s in nbrs[i] if s >= 0]
        assert got == oracle.neighbors[i], f"node {i}"


def test_sequential_build_matches_jax_and_oracle(rng):
    _sequential_build(rng, "l2", "int4")


@pytest.mark.parametrize("metric,edge", DEFAULT_CODECS)
def test_sequential_default_codec_build_matches_jax_and_oracle(
    rng, metric, edge
):
    _sequential_build(rng, metric, edge, n=60)


def _batched_build(rng, metric, edge, dims=16, n=800):
    jax_cfg, cfg = _configs(dims, metric=metric, edge=edge)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    port = Coordinator(cfg, initial_capacity=n, device="cpu")
    port.bulk_build(list(range(n)), data, max_batch=128)
    jax_coord = JaxCoordinator(jax_cfg, initial_capacity=n)
    jax_coord.bulk_build(list(range(n)), data, max_batch=128)
    _assert_same_graph(port, jax_coord)


def test_batched_bulk_build_matches_jax(rng):
    _batched_build(rng, "l2", "int4")


@pytest.mark.parametrize("metric,edge", DEFAULT_CODECS)
def test_batched_default_codec_build_matches_jax(rng, metric, edge):
    _batched_build(rng, metric, edge, n=500)


def test_ramp_follows_graph_size(rng):
    dims, n = 8, 300
    data = rng.standard_normal((n, dims)).astype(np.float32)
    port = Coordinator(_config(dims), initial_capacity=n, device="cpu")
    port.bulk_build(list(range(n)), data, max_batch=64)
    # Bootstrap node, then widths 1, 2, 4, ... capped at max_batch.
    widths = [b for b, _ in port.build_timings]
    assert widths == [1, 2, 4, 8, 16, 32, 64, 64, 64, 44]
    assert build_schedule(n - 1, 64)[:7] == widths[:7]
    assert port.count == n and int(port.arrays.valid.sum()) == n


def test_batched_build_recall(rng):
    """recall@10 vs brute force on the clustered set of test_build.py, at
    that file's INT4 bar (0.85); returned distances are exact."""
    dims, n, k = 48, 2000, 10
    cfg = _config(dims, r=16, l_insert=32, l_search=96)
    coord = Coordinator(cfg, initial_capacity=2048, device="cpu")
    data = clustered_data(rng, n, dims)
    coord.bulk_build(list(range(n)), data, max_batch=256)
    qidx = rng.integers(0, n, 32)
    queries = data[qidx] + 0.05 * rng.standard_normal((32, dims)).astype(
        np.float32
    )
    ids, dists = coord.search(queries, k)
    truth = brute_force_topk(queries, data, MetricType.L2, k)
    recall = np.mean([
        len(set(ids[b].tolist()) & set(truth[b].tolist())) / k
        for b in range(len(queries))
    ])
    assert recall >= 0.85, f"recall@{k} = {recall}"
    for b in range(3):
        for j in range(k):
            want = exact_distance(queries[b], data[ids[b, j]], MetricType.L2)
            assert abs(float(dists[b, j]) - want) < 1e-4


def test_rank_within_group():
    keys = torch.tensor([1, 1, 1, 4, 5, 5, 9, 9, 9, 9], dtype=torch.int32)
    assert _rank_within_group(keys).tolist() == [0, 1, 2, 0, 0, 1, 0, 1, 2, 3]


def test_insert_rejects_duplicates_and_bad_dims(rng):
    port = Coordinator(_config(8), device="cpu")
    data = rng.standard_normal((4, 8)).astype(np.float32)
    port.insert([0, 1, 2, 3], data)
    with pytest.raises(KeyError):
        port.insert([3], data[:1])
    with pytest.raises(ValueError, match="dimensions"):
        port.insert([9], np.zeros((1, 7), np.float32))
    assert port.count == 4
