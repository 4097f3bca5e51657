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
