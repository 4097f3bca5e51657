"""Multi-process work over ``torch.distributed``: the entry path, the
process mesh, and a disjoint-shard index whose processes each build and
hold only their own shards.

Counterpart of ``duckdb_lm_diskann_tpu/parallel/multihost.py``:

  * **Entry path**: every process calls :func:`initialize_distributed`
    with the same ``init_method`` (``tcp://host:port``) and world size and
    its own rank. The backend is NCCL when this process owns CUDA devices
    and Gloo on the CPU; there is no switch and no fallback between them,
    and a failed init raises.
  * **Placement**: :func:`make_global_mesh` numbers the shards
    process-major: process r owns shards r * n .. r * n + n - 1 of its n
    local devices (``mesh.ProcessMesh``).
  * **Disjoint shards** (:class:`MultiHostShardedIndex`): every process
    partitions the same rows round-robin (``sharded.partition_rows``) and
    builds only its shards; a search runs the local shards, exchanges the
    [n, B, k] (row id, distance) candidates with one ``all_gather`` and
    merges all S of them with the deterministic (distance, id) sort, so
    every process returns the same answer.
  * **One global graph across processes**: ``global_graph.
    GlobalShardedIndex`` over a ``ProcessMesh`` holds only this process's
    row blocks and reassembles a row by owner contribution plus
    ``all_reduce(SUM)`` over its bits (x + 0 = x, exactly); its
    checkpoint is shard-parallel (each process writes its own blocks,
    process 0 commits).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphParams
from .mesh import ProcessMesh
from .sharded import merge_candidates, partition_rows, shard_candidates


def initialize_distributed(
    init_method: str, world_size: int, rank: int, device=None
) -> str:
    """Join the process group: call once per process, before any
    collective. The backend follows ``device`` (default: this process's
    card, if any): NCCL on a CUDA device, Gloo on the CPU. Returns the
    backend."""
    import torch.distributed as dist

    if device is None:
        device = (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu")
        )
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank
    )
    return backend


def make_global_mesh(local_devices) -> ProcessMesh:
    """The process-major mesh of every process's ``local_devices`` (each
    process passes as many)."""
    import torch.distributed as dist

    return ProcessMesh(local_devices, dist.get_rank(), dist.get_world_size())


class MultiHostShardedIndex:
    """A disjoint-shard index spread over processes: each process builds
    and holds only the subgraphs of its own devices; a search is one
    ``all_gather`` of candidates, and its merged answer is the same on
    every process."""

    def __init__(self, config: LmDiskannConfig, mesh: ProcessMesh | None = None):
        config.validate()
        self.config = config
        self.params = GraphParams.from_config(config)
        if mesh is None:  # one shard on this process's card
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MultiHostShardedIndex(): no CUDA card; pass a mesh of "
                    "this process's devices (make_global_mesh(['cpu', ...]))"
                )
            mesh = make_global_mesh(
                [torch.device("cuda", torch.cuda.current_device())]
            )
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.local_shards = mesh.local_shards
        self.coordinators: dict[int, Coordinator] = {}

    def build(self, rowids, vectors: np.ndarray, max_batch: int = 1024) -> None:
        """Build the local shards from the global round-robin partition.
        Every process passes the same (rowids, vectors) view, or at scale
        a loader's view holding at least its own partitions' rows."""
        vectors = np.ascontiguousarray(np.atleast_2d(vectors), np.float32)
        rowids = np.asarray(rowids, np.int64)
        parts = partition_rows(len(rowids), self.n_shards)
        for s in self.local_shards:
            coord = Coordinator(self.config, device=self.mesh.device_of(s))
            if len(parts[s]):
                coord.bulk_build(
                    rowids[parts[s]].tolist(), vectors[parts[s]],
                    max_batch=max_batch,
                )
            self.coordinators[s] = coord

    def search(self, queries: np.ndarray, k: int, l_search: int | None = None):
        """Top-k over every process's shards; (rowids i64[B, k], dists
        f32[B, k]) as numpy, identical on every process."""
        import torch.distributed as dist

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        L = max(l_search if l_search is not None else self.config.l_search, k)
        home = self.mesh.devices[0]
        ids, dists = shard_candidates(
            [self.coordinators[s] for s in self.local_shards],
            self.mesh.devices, queries, k, L, home,
        )
        all_ids = [torch.empty_like(ids) for _ in range(self.mesh.world_size)]
        all_d = [torch.empty_like(dists) for _ in range(self.mesh.world_size)]
        dist.all_gather(all_ids, ids)
        dist.all_gather(all_d, dists)
        m_ids, m_d = merge_candidates(torch.cat(all_ids), torch.cat(all_d), k)
        return m_ids.cpu().numpy(), m_d.cpu().numpy()
