"""One set of index options, two configs: the JAX package's and the port's.

The port keeps its own enums and config class (it imports nothing of the
JAX package), and refuses the JAX package's. A parity test therefore builds
both sides' configs from the same options with ``configs``, and turns a
metric name into both sides' members with ``metrics``.
"""

from duckdb_lm_diskann_tpu.common import types as jax_types
from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig as JaxConfig
from duckdb_lm_diskann_tpu_torch.common import types as port_types
from duckdb_lm_diskann_tpu_torch.core.config import (
    LmDiskannConfig as PortConfig,
)

METRIC_NAMES = ["l2", "ip", "cosine"]


def metrics(name: str):
    """(JAX MetricType, port MetricType) of one metric name."""
    return (
        jax_types.MetricType.parse(name),
        port_types.MetricType.parse(name),
    )


def configs(
    metric="l2", edge_type="int4", dims=16, r=8, l_insert=16, l_search=32,
    **extra,
):
    """(JAX config, port config), both validated, from one set of options.
    ``edge_type=None`` leaves the codec to each side's metric default."""
    out = []
    for types, cls in ((jax_types, JaxConfig), (port_types, PortConfig)):
        cfg = cls(
            metric_type=types.MetricType.parse(metric),
            r=r,
            l_insert=l_insert,
            l_search=l_search,
            dimensions=dims,
            node_vector_type=types.VectorType.FLOAT32,
            edge_type=(
                None if edge_type is None else types.EdgeType.parse(edge_type)
            ),
            **extra,
        )
        cfg.validate()
        out.append(cfg)
    return tuple(out)


def jax_graph(metric, edge_type, n=300, dims=16, nq=12, seed=0x5E7E):
    """A graph built by the JAX Coordinator from seeded data, the port's
    config of it, the data and noisy queries near data points."""
    import numpy as np

    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator

    rng = np.random.default_rng(seed)
    jax_cfg, port_cfg = configs(metric=metric, edge_type=edge_type, dims=dims)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    coord = Coordinator(jax_cfg, initial_capacity=n)
    coord.bulk_build(list(range(n)), data, max_batch=64)
    queries = data[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal(
        (nq, dims)
    ).astype(np.float32)
    return coord, port_cfg, data, queries


def port_coordinator_from_jax(jax_coord, port_cfg):
    """A CPU port Coordinator holding a copy of a JAX Coordinator's whole
    state: graph arrays, allocator, entry point and flags."""
    import numpy as np

    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.core.graph import graph_arrays_from_numpy

    port = Coordinator(
        port_cfg, initial_capacity=jax_coord.capacity, device="cpu"
    )
    port.arrays = graph_arrays_from_numpy(jax_coord.arrays, "cpu")
    a, b = port.allocator, jax_coord.allocator
    a.rowid_to_slot = dict(b.rowid_to_slot)
    a.slot_to_rowid = dict(b.slot_to_rowid)
    a.free_slots = list(b.free_slots)
    a.pending_deletion = list(b.pending_deletion)
    a.high_water = b.high_water
    port.entry_slot, port.entry_rowid = jax_coord.entry_slot, jax_coord.entry_rowid
    port._slot_rowids = np.array(jax_coord._slot_rowids, copy=True)
    port._ever_tombstoned = jax_coord._ever_tombstoned
    port._needs_reachability_repair = jax_coord._needs_reachability_repair
    port.dirty = jax_coord.dirty
    return port


def jax_coordinator_copy(jax_coord):
    """A mutable copy of a JAX Coordinator (its snapshot, unfrozen), so that
    one built graph can serve several tests that mutate it."""
    copy = jax_coord.snapshot()
    del copy._frozen
    copy.donate_buffers = jax_coord.donate_buffers
    copy.dirty = jax_coord.dirty
    copy._needs_reachability_repair = jax_coord._needs_reachability_repair
    return copy


def assert_same_state(jax_coord, port):
    """The port's index state equals the JAX Coordinator's: every graph
    table (edge scales at rtol 1e-6: XLA multiplies by a rounded
    reciprocal where the port divides), the entry point, the allocator and
    the flags."""
    import numpy as np

    got = port.arrays.to_numpy()
    for name in got._fields:
        want = np.asarray(getattr(jax_coord.arrays, name))
        have = getattr(got, name)
        assert have.shape == want.shape and have.dtype == want.dtype, name
        if name == "edge_scale":
            np.testing.assert_allclose(have, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)
    assert (port.entry_slot, port.entry_rowid) == (
        jax_coord.entry_slot, jax_coord.entry_rowid
    )
    a, b = port.allocator, jax_coord.allocator
    assert a.rowid_to_slot == b.rowid_to_slot
    assert a.slot_to_rowid == b.slot_to_rowid
    assert a.free_slots == b.free_slots
    assert a.pending_deletion == b.pending_deletion
    assert a.high_water == b.high_water
    np.testing.assert_array_equal(port._slot_rowids, jax_coord._slot_rowids)
    assert port._ever_tombstoned == jax_coord._ever_tombstoned
    assert port.dirty == jax_coord.dirty
    assert (
        port._needs_reachability_repair
        == jax_coord._needs_reachability_repair
    )
