"""The four codecs without a TPU kernel (FLOAT32, FLOAT16, NONE, FLOAT1BIT)
and INT8 node vectors: the port against the JAX package on the CPU.

One JAX-built graph per codec is shared by the file's tests. Carried
across (``graph_arrays_from_numpy``) and searched with each metric the
codec allows, it gives identical visit orders and top-k ids on both sides,
with distances at rtol 1e-5. The port's own ``bulk_build`` gives the JAX
package's tables exactly (FLOAT1BIT's scores are integers; the float
codecs meet no f32 tie on these shapes).
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import EdgeType, VectorType
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import (
    GraphParams,
    graph_arrays_from_numpy,
)
from duckdb_lm_diskann_tpu_torch.core.searcher import beam_search
from tests.torch_configs import METRIC_NAMES, configs
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

N, DIMS, NQ = 300, 24, 12  # 24 dims: FLOAT1BIT's words carry pad bits
OPTS = dict(dims=DIMS, r=8, l_insert=16, l_search=32)

# Each codec's build metric; FLOAT1BIT is cosine-only (validate()).
BUILD_METRIC = {
    "float32": "l2", "float16": "cosine", "none": "ip", "float1bit": "cosine",
}
SEARCHES = [
    (codec, metric)
    for codec in ("float32", "float16", "none")
    for metric in METRIC_NAMES
] + [("float1bit", "cosine")]


_BUILT: dict = {}


def _data():
    rng = np.random.default_rng(0xC0DEC)
    data = rng.standard_normal((N, DIMS)).astype(np.float32)
    queries = data[rng.integers(0, N, NQ)] + 0.05 * rng.standard_normal(
        (NQ, DIMS)
    ).astype(np.float32)
    return data, queries


def built(codec):
    """(JAX Coordinator, port Coordinator) of one codec, both bulk-built
    from the same seeded data; built once per process, on first use."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    if codec not in _BUILT:
        data, _ = _data()
        jax_cfg, port_cfg = configs(
            metric=BUILD_METRIC[codec], edge_type=codec, **OPTS
        )
        jc = JaxCoordinator(jax_cfg, initial_capacity=N)
        jc.bulk_build(list(range(N)), data, max_batch=64)
        pc = Coordinator(port_cfg, initial_capacity=N, device="cpu")
        pc.bulk_build(list(range(N)), data, max_batch=64)
        _BUILT[codec] = (jc, pc)
    return _BUILT[codec]


@pytest.mark.parametrize("codec", sorted(BUILD_METRIC))
def test_bulk_build_tables_match_jax(codec):
    jc, pc = built(codec)
    assert pc.params.edge_type is EdgeType.parse(codec)
    got = pc.arrays.to_numpy()
    for name in got._fields:
        want = np.asarray(getattr(jc.arrays, name))
        assert getattr(got, name).dtype == want.dtype, name
        np.testing.assert_array_equal(getattr(got, name), want, err_msg=name)
    assert (pc.entry_slot, pc.entry_rowid) == (jc.entry_slot, jc.entry_rowid)


@pytest.mark.parametrize("codec,metric", SEARCHES)
def test_search_on_a_jax_graph_matches_jax(codec, metric):
    """beam_search on the JAX-built graph: visit order, visit counts, hops
    and top-k identical, exact distances at rtol 1e-5."""
    from duckdb_lm_diskann_tpu.core.graph import GraphParams as JaxParams
    from duckdb_lm_diskann_tpu.core.searcher import (
        beam_search as jax_beam_search,
    )
    import jax.numpy as jnp

    _, queries = _data()
    jc, _ = built(codec)
    jax_cfg, port_cfg = configs(metric=metric, edge_type=codec, **OPTS)
    jp = JaxParams.from_config(jax_cfg)
    pp = GraphParams.from_config(port_cfg)
    arrays = graph_arrays_from_numpy(jc.arrays, "cpu")
    want = jax_beam_search(
        jc.arrays, jnp.asarray(queries), jnp.int32(jc.entry_slot),
        params=jp, l_search=32, k=10,
    )
    got = beam_search(
        arrays, torch.from_numpy(queries), jc.entry_slot,
        params=pp, l_search=32, k=10,
    )
    np.testing.assert_array_equal(
        got.visited_count.numpy(), np.asarray(want.visited_count)
    )
    np.testing.assert_array_equal(
        got.visited_slots.numpy(), np.asarray(want.visited_slots)
    )
    np.testing.assert_array_equal(
        got.topk_slots.numpy(), np.asarray(want.topk_slots)
    )
    np.testing.assert_allclose(
        got.topk_dists.numpy(), np.asarray(want.topk_dists),
        rtol=1e-5, atol=1e-6,
    )
    assert int(got.hops) == int(want.hops)


def test_every_codec_is_accepted_with_both_node_types():
    """Coordinator takes all seven edge types with FLOAT32 and INT8 node
    vectors wherever the config's metric rules allow (FLOAT1BIT cosine
    only; the sign-plane codecs not with L2), and refuses exactly the
    combinations the JAX package's config refuses."""
    from duckdb_lm_diskann_tpu.common import types as jt
    from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig as JaxCfg
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig

    accepted = 0
    for et in EdgeType:
        for vt in (VectorType.FLOAT32, VectorType.INT8):
            for metric in MetricType:
                opts = dict(r=4, l_insert=8, dimensions=8)
                cfg = LmDiskannConfig(
                    metric_type=metric, node_vector_type=vt, edge_type=et,
                    **opts,
                )
                jax_cfg = JaxCfg(
                    metric_type=jt.MetricType.parse(metric.value),
                    node_vector_type=jt.VectorType(vt.value),
                    edge_type=jt.EdgeType.parse(et.value), **opts,
                )
                try:
                    jax_cfg.validate()
                except ValueError:
                    with pytest.raises(ValueError):
                        Coordinator(cfg, device="cpu")
                    continue
                coord = Coordinator(cfg, device="cpu")
                assert coord.arrays.vectors.dtype == (
                    torch.int8 if vt is VectorType.INT8 else torch.float32
                )
                accepted += 1
    # Each codec with at least one metric, under both node types.
    assert accepted >= 2 * len(EdgeType)


def _int8_configs(metric, edge, vtype, dims=16):
    jax_cfg, port_cfg = configs(
        metric=metric, edge_type=edge, dims=dims, r=8, l_insert=16,
        l_search=64,
    )
    port_cfg.node_vector_type = vtype
    port_cfg.validate()
    return jax_cfg, port_cfg


@pytest.mark.parametrize("metric,edge", [("l2", "int8"), ("cosine", "ternary")])
def test_int8_storage_dtype_and_search_parity(rng, metric, edge):
    """(tests/test_int8_nodes.py, case 1, on the port.) An INT8-node index
    stores int8 and answers exactly as a FLOAT32-node index over the same
    integral data, in a quarter of the vector bytes."""
    n, d = 200, 16
    data = rng.integers(-128, 128, (n, d)).astype(np.int8)
    coords = {}
    for vt in (VectorType.INT8, VectorType.FLOAT32):
        _, cfg = _int8_configs(metric, edge, vt, d)
        coords[vt] = Coordinator(cfg, initial_capacity=256, device="cpu")
        coords[vt].bulk_build(list(range(n)), data.astype(np.float32))
    c8, cf = coords[VectorType.INT8], coords[VectorType.FLOAT32]
    assert c8.arrays.vectors.dtype == torch.int8
    assert cf.arrays.vectors.dtype == torch.float32
    v8, vf = c8.arrays.vectors, cf.arrays.vectors
    assert v8.numel() * v8.element_size() * 4 == vf.numel() * vf.element_size()
    q = data[rng.integers(0, n, 8)].astype(np.float32)
    ids8, d8 = c8.search(q, 5)
    idsf, df = cf.search(q, 5)
    np.testing.assert_array_equal(ids8, idsf)
    np.testing.assert_allclose(d8, df, rtol=1e-6, atol=1e-6)


def test_int8_quantization_round_clamp():
    """(tests/test_int8_nodes.py, case 2, on the port.) Float input to an
    INT8-node index is rounded half to even and clamped."""
    _, cfg = _int8_configs("l2", "int8", VectorType.INT8, dims=8)
    c = Coordinator(cfg, initial_capacity=256, device="cpu")
    c.insert([0], np.full((1, 8), 200.7, np.float32))  # clamps to 127
    c.insert([1], np.asarray([[0.5, 1.5, 2.5, -0.5, -1.5, -200.0, 3.49, -3.51]],
                             np.float32))
    stored = c.arrays.vectors[:2].numpy()
    assert stored.dtype == np.int8
    np.testing.assert_array_equal(stored[0], np.full(8, 127, np.int8))
    np.testing.assert_array_equal(stored[1], [0, 2, 2, 0, -2, -128, 3, -4])


def test_int8_nodes_build_matches_jax(rng):
    """The INT8-node build against the JAX package's: identical neighbor
    tables and int8 vectors from non-integral input (rounded on store)."""
    from duckdb_lm_diskann_tpu.common.types import VectorType as JaxVT
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    n, d = 200, 16
    data = (40 * rng.standard_normal((n, d))).astype(np.float32)
    jax_cfg, port_cfg = _int8_configs("l2", "int8", VectorType.INT8, d)
    jax_cfg.node_vector_type = JaxVT.INT8
    jax_cfg.validate()
    jc = JaxCoordinator(jax_cfg, initial_capacity=256)
    jc.bulk_build(list(range(n)), data, max_batch=64)
    pc = Coordinator(port_cfg, initial_capacity=256, device="cpu")
    pc.bulk_build(list(range(n)), data, max_batch=64)
    got = pc.arrays.to_numpy()
    np.testing.assert_array_equal(got.vectors, np.asarray(jc.arrays.vectors))
    np.testing.assert_array_equal(got.neighbors, np.asarray(jc.arrays.neighbors))
    np.testing.assert_array_equal(got.edge_i8, np.asarray(jc.arrays.edge_i8))
    q = data[:6] + 0.5
    want_ids, want_d = jc.search(q, 5)
    got_ids, got_d = pc.search(q, 5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)
