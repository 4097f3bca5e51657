"""Record the JAX package's sharded answers that
``tests/test_torch_parallel.py`` holds the port to, into
``tests/golden/torch_parallel_jax.npz``:

  * the JAX ``ShardedIndex`` over its 8-device CPU mesh, 800 x 16 rows,
    L2 / INT4, top-10 of 16 queries (ids and distances);
  * a 128-row JAX Coordinator's graph and its ``GlobalShardedIndex``
    answer over a 4-device mesh (top-5 of 6 queries at L = 32).

Recorded once, as ``tests/torch_record_serving.py`` does, so that the
port's test runs no JAX program in its pytest worker. Run from the
repository root (under a minute on the CPU):

    python tests/torch_record_parallel.py
"""

import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "golden", "torch_parallel_jax.npz")
DIMS = 16
GRAPH_FIELDS = (
    "vectors", "neighbors", "valid", "edge_pos", "edge_neg", "edge_i8",
    "edge_i4", "edge_scale", "edge_f32", "dirty_rows",
)


def data_and_queries(seed, n, dims=DIMS, nq=12):
    """The seeded rows and noisy queries near them (the test's inputs)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    q = data[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal(
        (nq, dims)
    ).astype(np.float32)
    return data, q.astype(np.float32)


DISJOINT = dict(seed=0x800, n=800, nq=16)
GLOBAL = dict(seed=0x61, n=128, nq=6)


def main() -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.parallel.global_graph import GlobalShardedIndex
    from duckdb_lm_diskann_tpu.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu.parallel.sharded import ShardedIndex
    from tests.torch_configs import configs

    rec = {}
    data, q = data_and_queries(**DISJOINT)
    jax_cfg, _ = configs(metric="l2", edge_type="int4", dims=DIMS, l_search=48)
    idx = ShardedIndex(jax_cfg, mesh=make_mesh(8))
    idx.build(np.arange(len(data)), data, max_batch=128)
    rec["disjoint/ids"], rec["disjoint/dists"] = idx.search(q, 10)

    data, q = data_and_queries(**GLOBAL)
    jax_cfg, _ = configs(metric="l2", edge_type="int4", dims=DIMS)
    jc = Coordinator(jax_cfg, initial_capacity=len(data))
    jc.bulk_build(list(range(len(data))), data, max_batch=32)
    for f in GRAPH_FIELDS:
        rec[f"global/graph/{f}"] = np.asarray(getattr(jc.arrays, f))
    rec["global/entry_slot"] = np.int32(jc.entry_slot)
    rec["global/slot_rowids"] = np.asarray(jc._slot_rowids)
    rec["global/ids"], rec["global/dists"] = GlobalShardedIndex(
        jc, mesh=make_mesh(4)
    ).search(q, 5, l_search=32)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {len(rec)} arrays to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
