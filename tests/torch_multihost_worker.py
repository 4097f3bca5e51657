"""One process of the port's two-process test (tests/test_torch_multihost.py).

Each process owns two CPU shards of a four-shard process mesh; Gloo carries
the collectives. Imports torch and the port only.

Usage: python torch_multihost_worker.py <rank> <world> <init_method> <out_dir>
"""

import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_method, out_dir = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)

    from duckdb_lm_diskann_tpu_torch.common import types as T
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu_torch.parallel import multihost
    from duckdb_lm_diskann_tpu_torch.parallel.global_graph import (
        GlobalShardedIndex,
        load_global_sharded,
    )
    from duckdb_lm_diskann_tpu_torch.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu_torch.parallel.sharded import ShardedIndex

    backend = multihost.initialize_distributed(
        init_method, world, rank, device="cpu"
    )
    assert backend == "gloo", backend
    mesh = multihost.make_global_mesh(["cpu", "cpu"])
    assert mesh.n_shards == 2 * world and mesh.local_shards == [2 * rank, 2 * rank + 1]

    rng = np.random.default_rng(7)
    n, d = 240, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((4, d)).astype(np.float32)
    cfg = LmDiskannConfig(
        metric_type=T.MetricType.L2, r=8, l_insert=16, alpha=1.2, l_search=64,
        dimensions=d, node_vector_type=T.VectorType.FLOAT32,
        edge_type=T.EdgeType.INT8,
    )
    cfg.validate()
    out = {"rank": rank}

    # Disjoint shards across processes == one process holding all four.
    idx = multihost.MultiHostShardedIndex(cfg, mesh=mesh)
    idx.build(list(range(n)), data, max_batch=64)
    assert sorted(idx.coordinators) == mesh.local_shards
    ids, dists = idx.search(queries, 5)
    one = ShardedIndex(cfg, mesh=make_mesh("cpu", 2 * world))
    one.build(list(range(n)), data, max_batch=64)
    ids1, dists1 = one.search(queries, 5)
    out["disjoint_equal"] = bool(
        np.array_equal(ids, ids1) and np.array_equal(dists, dists1)
    )

    # One global graph across the processes == the single Coordinator.
    coord = Coordinator(cfg, device="cpu")
    coord.bulk_build(list(range(n)), data, max_batch=64)
    want = coord.search(queries, 5)
    gidx = GlobalShardedIndex(coord, mesh=mesh)
    got = gidx.search(queries, 5)
    out["global_equal"] = bool(
        np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    )

    # Distributed build across the processes == bulk_build, then a delete.
    gd = GlobalShardedIndex(Coordinator(cfg, device="cpu"), mesh=mesh)
    gd.distributed_build(list(range(n)), data, max_batch=64)
    same = all(
        torch.equal(getattr(coord.arrays, f)[:n], getattr(gd.coordinator.arrays, f).cpu()[:n])
        for f in coord.arrays._fields
    ) and coord.entry_slot == gd.coordinator.entry_slot
    out["build_equal"] = bool(same)
    dels = list(range(0, n, 9))
    coord.delete(dels)
    gd.delete(dels)
    out["delete_equal"] = bool(all(
        torch.equal(getattr(coord.arrays, f)[:n], getattr(gd.coordinator.arrays, f).cpu()[:n])
        for f in coord.arrays._fields
    ))

    # Shard-parallel checkpoint: each process writes its blocks, process 0
    # commits; every process reopens it row-sharded.
    before = gd.search(queries, 5)
    info = gd.save(os.path.join(out_dir, "ckpt"))
    out["blocks_written"] = info["blocks_written"]
    g2 = load_global_sharded(os.path.join(out_dir, "ckpt"), mesh=mesh, device="cpu")
    after = g2.search(queries, 5)
    out["ckpt_equal"] = bool(
        np.array_equal(before[0], after[0]) and np.array_equal(before[1], after[1])
    )
    # An insert past the capacity re-splits the blocks across processes
    # (dirty_rows differ: only gd was saved since the build).
    more = rng.standard_normal((20, d)).astype(np.float32)
    gd.insert(list(range(n, n + 20)), more)
    coord.insert(list(range(n, n + 20)), more)
    out["grow_equal"] = bool(gd.coordinator.capacity == 2 * n and all(
        torch.equal(getattr(coord.arrays, f)[: n + 20],
                    getattr(gd.coordinator.arrays, f).cpu()[: n + 20])
        for f in coord.arrays._fields if f != "dirty_rows"
    ))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
