"""Disjoint shards: S independent subgraphs, one per mesh device, searched
side by side and merged.

Counterpart of ``duckdb_lm_diskann_tpu/parallel/sharded.py``:

  * rows are partitioned round-robin (``partition_rows``) into S shards;
    each shard is a whole port ``Coordinator`` whose tables live on its
    mesh device, with its own entry point;
  * search runs every shard's beam search on its own device (its own
    entry, its own ``assume_all_valid``), maps each shard's top-k slots to
    row ids, brings the [S, B, k] (row id, distance) candidates to the
    first device and keeps the k best by the deterministic (distance, id)
    sort of ``ops/topk.py``: the answer is the merge of the shards' own
    ``Coordinator.search`` answers;
  * dynamic inserts go to the smallest shards; delete, update, save and
    ``load_sharded`` work shard by shard (``shard_NNN/`` directories in
    the single-index format, plus ``sharded.json``).

The JAX package stacks the shards into global [S, ...] arrays for
``shard_map`` (``StackedGraphArrays``, its incremental restack, and the
hi/lo split of 64-bit row ids that JAX's 32-bit default integers need).
Here each shard's tensors stay resident on their device and torch has
int64, so none of that exists: a mutation touches its own shard's tensors
only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..common.types import INVALID_ROW_ID
from ..core import builder
from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, GraphParams
from ..core.searcher import beam_search
from ..ops import topk as topk_ops
from .mesh import check_placement, make_mesh


def partition_rows(n: int, n_shards: int) -> list[np.ndarray]:
    """Round-robin (hash-mod) partition of row indices -> per-shard lists."""
    return [np.arange(n)[i::n_shards] for i in range(n_shards)]


def shard_candidates(
    coordinators, devices, queries: np.ndarray, k: int, l_search: int, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each shard's top-k as (row ids i64[S, B, k], distances f32[S, B, k])
    on ``device``: the shard's beam search from its entry point on its
    device (``devices[s]``; a shard found elsewhere raises), its slots
    mapped to row ids there; empty results are (-1, +inf)."""
    B = queries.shape[0]
    ids, dists = [], []
    for c, dev in zip(coordinators, devices, strict=True):
        check_placement(c.arrays.vectors, dev, "a shard's tables")
        if c.count == 0 or c.entry_slot < 0:
            ids.append(torch.full((B, k), INVALID_ROW_ID, dtype=torch.int64, device=device))
            dists.append(torch.full((B, k), float("inf"), device=device))
            continue
        res = beam_search(
            c.arrays, torch.as_tensor(queries, device=dev), c.entry_slot,
            params=c.params, l_search=l_search, k=k,
            assume_all_valid=not c._ever_tombstoned,
        )
        slots = res.topk_slots.long()
        rowids = torch.as_tensor(c._slot_rowids, device=dev)
        ok = slots >= 0
        gid = torch.where(ok, rowids[slots.clamp_min(0)], INVALID_ROW_ID)
        ids.append(gid.to(device))
        dists.append(torch.where(ok, res.topk_dists, float("inf")).to(device))
    return torch.stack(ids), torch.stack(dists)


def merge_candidates(
    ids: torch.Tensor, dists: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """[S, B, k] candidates -> the k best per query by (distance, row id),
    the union's deterministic sort; invalid entries (+inf) sort last."""
    S, B, K = ids.shape
    flat_ids = ids.permute(1, 0, 2).reshape(B, S * K)
    flat_d = dists.permute(1, 0, 2).reshape(B, S * K)
    d, i = topk_ops.sort_by_distance_id(flat_d, flat_ids)
    return i[:, :k], d[:, :k]


def sharded_search(coordinators, mesh, queries, *, k: int, l_search: int):
    """Per-shard beam search (shard s on ``mesh[s]``) + one (distance, id)
    merge on ``mesh[0]``. Returns (row ids i64[B, k], distances f32[B, k])
    as tensors."""
    ids, dists = shard_candidates(
        coordinators, mesh, queries, k, l_search, mesh[0]
    )
    return merge_candidates(ids, dists, k)


class ShardedIndex:
    """S port Coordinators, shard s on ``mesh[s]``, over disjoint rows."""

    def __init__(self, config: LmDiskannConfig, mesh=None):
        config.validate()
        self.config = config
        self.params = GraphParams.from_config(config)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = len(self.mesh)
        self.coordinators = [Coordinator(config, device=d) for d in self.mesh]

    def build(self, rowids, vectors: np.ndarray, max_batch: int = 1024) -> None:
        vectors = np.ascontiguousarray(np.atleast_2d(vectors), np.float32)
        rowids = np.asarray(rowids, np.int64)
        for s, part in enumerate(partition_rows(len(rowids), self.n_shards)):
            if len(part):
                self.coordinators[s].bulk_build(
                    rowids[part].tolist(), vectors[part], max_batch=max_batch
                )

    def insert(self, rowids, vectors: np.ndarray) -> None:
        """Dynamic insert: route new rows to the smallest shards."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        order = np.argsort([c.count for c in self.coordinators], kind="stable")
        parts = np.array_split(np.arange(len(vectors)), self.n_shards)
        for s, part in zip(order, parts):
            if len(part):
                self.coordinators[s].insert(
                    [int(rowids[i]) for i in part], vectors[part]
                )

    def delete(self, rowids) -> int:
        return sum(c.delete(rowids) for c in self.coordinators)

    def update(self, rowid: int, vector) -> None:
        """Update = delete + re-insert (Coordinator::Update semantics)."""
        self.delete([int(rowid)])
        self.insert([int(rowid)], np.atleast_2d(np.asarray(vector)))

    @property
    def count(self) -> int:
        return sum(c.count for c in self.coordinators)

    def search(self, queries: np.ndarray, k: int, l_search: int | None = None):
        """Top-k over every shard. Returns (rowids i64[B, k], dists
        f32[B, k]) as numpy arrays."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        L = max(l_search if l_search is not None else self.config.l_search, k)
        ids, dists = sharded_search(
            self.coordinators, self.mesh, queries, k=k, l_search=L
        )
        return ids.cpu().numpy(), dists.cpu().numpy()

    def save(self, directory) -> dict:
        """Checkpoint every shard into ``<directory>/shard_NNN/`` (the
        single-index format: each subgraph is self-contained, with no
        cross-shard edge) plus a ``sharded.json`` manifest."""
        from ..store.checkpoint import save_index

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        infos = [
            save_index(c, directory / f"shard_{s:03d}")
            for s, c in enumerate(self.coordinators)
        ]
        (directory / "sharded.json").write_text(
            json.dumps({"mode": "disjoint", "n_shards": self.n_shards})
        )
        return {"n_shards": self.n_shards, "shards": infos}


def load_sharded(directory, mesh=None) -> ShardedIndex:
    """Load a ShardedIndex saved by :meth:`ShardedIndex.save`, shard s onto
    ``mesh[s]``. The mesh must have the saved shard count (the row
    partition is baked into the subgraphs; re-sharding is a rebuild)."""
    from ..store.checkpoint import load_index

    directory = Path(directory)
    meta = json.loads((directory / "sharded.json").read_text())
    n_shards = int(meta["n_shards"])
    mesh = mesh if mesh is not None else make_mesh()
    if len(mesh) != n_shards:
        raise ValueError(
            f"mesh has {len(mesh)} devices but the checkpoint was saved "
            f"with {n_shards} shards"
        )
    coordinators = [
        load_index(directory / f"shard_{s:03d}", device=d)
        for s, d in enumerate(mesh)
    ]
    idx = ShardedIndex(coordinators[0].config, mesh=mesh)
    idx.coordinators = coordinators
    return idx


# --------------------------------------------------------------------- #
# one build step on every shard (the JAX package's device-only step)


def insert_batch_device(
    arrays: GraphArrays,
    new_slots: torch.Tensor,  # i32[M] pre-allocated slots
    new_vecs: torch.Tensor,  # f32[M, D]
    entry_slot: int,
    *,
    params: GraphParams,
) -> GraphArrays:
    """One batched insert step on one shard's tensors, in place: the bulk
    path's ``builder.insert_step`` (multi-round reciprocal replace/prune
    and the in-link guarantee, edge codes written inline)."""
    return builder.insert_step(
        arrays, new_slots, new_vecs, entry_slot, params=params,
        full_visited=False, recip_rounds=builder._RECIP_ROUNDS,
    )


def sharded_insert_step(
    shard_arrays, new_slots, new_vecs, entries, *, params: GraphParams
) -> list[GraphArrays]:
    """One build step on every shard (no cross-shard traffic: subgraphs are
    disjoint): ``insert_batch_device`` of shard s's batch on its tensors."""
    return [
        insert_batch_device(a, sl.to(a.device), v.to(a.device), int(e), params=params)
        for a, sl, v, e in zip(shard_arrays, new_slots, new_vecs, entries)
    ]
