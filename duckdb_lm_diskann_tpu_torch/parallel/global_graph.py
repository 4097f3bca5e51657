"""One graph, its rows split over the mesh: results identical to one device.

Counterpart of ``duckdb_lm_diskann_tpu/parallel/global_graph.py``. The
disjoint mode (:mod:`.sharded`) splits the corpus into independent
subgraphs; this mode keeps the single graph of one ``Coordinator`` (the
same slots, neighbor lists, edge codes and entry point) and splits its
tables by row: global slot g lives in row block g // (C/S) at local row
g % (C/S), so each device holds 1/S of the graph.

The JAX package runs its unchanged searcher and builder inside
``shard_map`` over ``PsumRows``, an array stand-in whose every gather is an
owner-masked local gather plus ``psum`` and whose every scatter is applied
by the owning shard only, with the Pallas kernels switched off. Here the
same unchanged code (``core/searcher.py``, ``core/builder.py`` and the
``Coordinator``'s own insert, delete, vacuum, repair and search) runs over
a ``GraphArrays`` whose fields are ``RowShardedTable``s:

  * a gather by global slot goes to the block that owns each slot and the
    owned rows are selected into one result on the Coordinator's device;
    a gather has no arithmetic, so the result is the single table's;
  * a write by global slot is applied by the owning block only;
  * the frontier kernels (INT4, INT8, TERNARY) take whole tables: each
    block's kernel is launched on its own table for the full batch of
    visited nodes (slots of other blocks clamped to local row 0), and
    each row keeps its owner's output. Every launch has the batch shape
    of the single-device search, so its float order is the single-device
    one (``searcher._frontier_scores``);
  * the in-link histogram is a sum of per-block histograms
    (``builder.inlink_histogram``) and the medoid's mean a sum of
    per-block partial sums (``_medoid``).

Everything else (distances, sorts, merges, prunes) runs on the
Coordinator's device at the shapes of the single-device run, so search,
build and DML give the single-device tables and answers; the medoid's
mean alone sums in another order, which could move the entry point only
between two rows equidistant from the mean to the last bit.

Across processes (``mesh.ProcessMesh``; ``multihost.py``) each process
holds only its own row blocks and every process runs the same program: a
gather is each owner's contribution (zeros elsewhere) summed by
``all_reduce`` over the values' bits as integers, x + 0 = x exactly, the
torch form of ``PsumRows``; a kernel's output is reassembled the same
way; writes land on the owner only. Saves are shard-parallel
(``_save_multiprocess``).

JAX's sharded twins of the delete programs (``_g_tombstone``,
``_g_delete_repair_round``, ``_g_rescue_round``, ``_g_refresh``,
``_g_force_links``, ``_g_gather_rows``) are the builder's own functions
over row-sharded tables here; ``_g_delete_repair_scan`` (rounds stacked
into one ``lax.scan`` dispatch for the TPU) and the power-of-two
capacities and paddings (compile reuse) are not ported.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..common.types import INVALID_ROW_ID
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, GraphParams, make_graph_arrays
from ..core.searcher import beam_search
from .mesh import ProcessMesh, check_placement, make_mesh

# Integer dtype of each element size: the collective sums a value's bits.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _sum_exact(t: torch.Tensor) -> torch.Tensor:
    """All-reduce of tensors in which at most one process holds a nonzero
    value per element: the bits are summed as integers, so each value
    arrives unchanged (an IEEE sum would turn -0.0 + 0.0 into +0.0)."""
    import torch.distributed as dist

    if t.dtype == torch.bool:
        x = t.to(torch.uint8)
        dist.all_reduce(x)
        return x.bool()
    x = t.contiguous().view(_BITS[t.element_size()])
    if x.dtype == torch.int16:  # widened: not every backend sums int16
        w = x.to(torch.int32)
        dist.all_reduce(w)
        return w.to(torch.int16).view(t.dtype)
    x = x.clone()
    dist.all_reduce(x)
    return x.view(t.dtype)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


class RowShardedTable:
    """A [C, ...] graph table held as S row blocks of C/S rows, block s on
    its shard's device, that the searcher and builder index like the
    table itself: ``t[idx]`` and ``t.index_select(0, idx)`` gather global
    rows (any index shape), ``t[rows, cols]`` gathers elements, ``t[lo:hi]``
    a row range, and ``t[rows] = v`` / ``t[rows, cols] = v`` write through
    the owning block. Results land on ``home``, the Coordinator's device.

    ``blocks[s]`` is None for a block another process holds; ``comm`` is
    then that process layout (a ``ProcessMesh``) and gathers are summed
    across the processes."""

    def __init__(self, blocks, rows: int, home, comm: ProcessMesh | None = None):
        self.blocks = list(blocks)
        self.rows = rows
        self.home = torch.device(home)
        self.comm = comm
        proto = next(b for b in self.blocks if b is not None)
        self._row_shape = tuple(proto.shape[1:])
        self.dtype = proto.dtype

    # ---- tensor-like attributes the engine reads --------------------- #

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.blocks) * self.rows,) + self._row_shape)

    @property
    def device(self) -> torch.device:
        return self.home

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _local(self):
        """(block index, block) of the blocks this process holds."""
        return [(s, b) for s, b in enumerate(self.blocks) if b is not None]

    # ---- reads -------------------------------------------------------- #

    def map_rows(self, fn, idx: torch.Tensor, *others: "RowShardedTable"):
        """``fn(local_idx, block, *other_blocks)`` -> one result row per
        entry of ``idx`` (i32/i64[N], global rows), run on every block for
        the whole of ``idx`` with the rows of other blocks clamped to local
        row 0; each result row is taken from the block that owns it."""
        idx = idx.to(self.home)
        out = None
        for s, blk in self._local():
            lo = s * self.rows
            own = (idx >= lo) & (idx < lo + self.rows)
            local = torch.where(own, idx - lo, 0).to(blk.device)
            part = fn(local, blk, *(o.blocks[s] for o in others)).to(self.home)
            if out is None:
                out = (
                    part if self.comm is None
                    else torch.where(_bcast(own, part), part, torch.zeros_like(part))
                )
            else:
                out = torch.where(_bcast(own, part), part, out)
        return out if self.comm is None else _sum_exact(out)

    def _gather(self, rows: torch.Tensor, cols: torch.Tensor | None = None):
        rows = torch.as_tensor(rows, device=self.home)
        flat = rows.reshape(-1).long()
        if cols is None:
            out = self.map_rows(lambda li, b: b[li], flat)
            return out.reshape(rows.shape + out.shape[1:])
        cols = torch.as_tensor(cols, device=self.home).reshape(-1).long()
        cols = cols.expand(flat.shape)
        out = self.map_rows(lambda li, b: b[li, cols.to(b.device)], flat)
        return out.reshape(rows.shape + out.shape[1:])

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        if dim != 0:
            raise ValueError("a row-sharded table gathers along dim 0 only")
        return self._gather(index)

    def _slice(self, key: slice) -> torch.Tensor:
        lo, hi, step = key.indices(self.shape[0])
        if step != 1:
            raise ValueError("a row-sharded table slices with step 1 only")
        if self.comm is not None:
            raise RuntimeError(
                "a row range of a table held by several processes is read "
                "through cpu() or per_block()"
            )
        parts = []
        for s, blk in enumerate(self.blocks):
            a, b = max(lo, s * self.rows), min(hi, (s + 1) * self.rows)
            if a < b:
                parts.append(blk[a - s * self.rows : b - s * self.rows].to(self.home))
        if not parts:
            return torch.empty((0,) + self._row_shape, dtype=self.dtype, device=self.home)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self._slice(key)
        if isinstance(key, tuple):
            if len(key) == 1:
                return self._gather(key[0])
            if len(key) == 2:
                return self._gather(key[0], key[1])
            raise IndexError(f"unsupported index of {len(key)} parts")
        if isinstance(key, torch.Tensor) and key.dtype == torch.bool:
            raise IndexError("a row-sharded table is indexed by row numbers")
        return self._gather(key)

    def per_block(self, fn, *others: "RowShardedTable") -> list:
        """[fn(block_s, *other_blocks_s) for every block s], in block order,
        on ``home`` (across processes each block's result is computed by
        its holder and gathered; results must have one shape)."""
        local = [
            fn(blk, *(o.blocks[s] for o in others)).to(self.home)
            for s, blk in self._local()
        ]
        if self.comm is None:
            return local
        import torch.distributed as dist

        mine = torch.stack(local)
        got = [torch.empty_like(mine) for _ in range(self.comm.world_size)]
        dist.all_gather(got, mine)
        return [r for g in got for r in g.unbind(0)]

    def cpu(self) -> torch.Tensor:
        """The whole table on the host (host passes: the reachability BFS,
        the entry fallback; host memory holds the whole table, each
        device only its blocks)."""
        return torch.cat([b.cpu() for b in self.per_block(lambda b: b)])

    # ---- writes ------------------------------------------------------- #

    def __setitem__(self, key, value) -> None:
        if isinstance(key, tuple):
            rows, cols = (key[0], key[1] if len(key) > 1 else None)
        else:
            rows, cols = key, None
        if isinstance(rows, slice) or (
            isinstance(rows, torch.Tensor) and rows.dtype == torch.bool
        ):
            raise IndexError("a row-sharded table is written by row numbers")
        rows = torch.as_tensor(rows, device=self.home).reshape(-1).long()
        if cols is not None:
            cols = torch.as_tensor(cols, device=self.home).reshape(-1).long()
        per_row = isinstance(value, torch.Tensor) and value.dim() > 0
        for s, blk in self._local():
            lo = s * self.rows
            sel = torch.nonzero((rows >= lo) & (rows < lo + self.rows)).squeeze(1)
            if sel.numel() == 0:
                continue
            li = (rows[sel] - lo).to(blk.device)
            v = value[sel].to(blk.device) if per_row else value
            if cols is None:
                blk[li] = v
            else:
                blk[li, cols[sel].to(blk.device)] = v

    def zero_(self) -> "RowShardedTable":
        for _, blk in self._local():
            blk.zero_()
        return self

    def clone(self) -> "RowShardedTable":
        return RowShardedTable(
            [None if b is None else b.clone() for b in self.blocks],
            self.rows, self.home, self.comm,
        )


def _blocks_of(mesh) -> tuple[list, ProcessMesh | None]:
    """(device of each block or None where another process holds it, the
    process layout or None)."""
    if isinstance(mesh, ProcessMesh):
        devs = [None] * mesh.n_shards
        for s, d in zip(mesh.local_shards, mesh.devices):
            devs[s] = d
        return devs, mesh
    return list(mesh), None


def _stack_rows(a: torch.Tensor, n_shards: int, fill=0) -> list[torch.Tensor]:
    """[C, ...] -> S row blocks of ceil(C/S) rows: views of ``a``, the last
    ones padded with rows of ``fill`` (never valid, never referenced)."""
    rows = -(-a.shape[0] // n_shards)
    out = []
    for s in range(n_shards):
        blk = a[s * rows : (s + 1) * rows]
        if blk.shape[0] < rows:
            pad = torch.full(
                (rows - blk.shape[0],) + tuple(a.shape[1:]), fill,
                dtype=a.dtype, device=a.device,
            )
            blk = torch.cat([blk, pad])
        out.append(blk)
    return out


def row_sharded_arrays(arrays: GraphArrays, mesh, home) -> GraphArrays:
    """A row-sharded copy of ``arrays`` (capacity padded to a multiple of
    the shard count): block s of every table is copied to its shard's
    device; across processes only this process's blocks are kept."""
    devs, comm = _blocks_of(mesh)
    out = {}
    for name in GraphArrays._fields:
        # padding rows: empty neighbor lists (-1), everything else 0
        fill = -1 if name == "neighbors" else 0
        blocks = _stack_rows(getattr(arrays, name), len(devs), fill)
        out[name] = RowShardedTable(
            [None if d is None else b.to(d, copy=True) for b, d in zip(blocks, devs)],
            blocks[0].shape[0], home, comm,
        )
    return GraphArrays(**out)


def _alloc_stacked(params: GraphParams, capacity: int, mesh, home) -> GraphArrays:
    """Fresh row-sharded tables of ``capacity`` rows: each block is
    allocated on its own device, so the whole table never exists on one."""
    devs, comm = _blocks_of(mesh)
    S = len(devs)
    if capacity % S:
        raise ValueError(f"capacity {capacity} is no multiple of {S} shards")
    rows = capacity // S
    per_block = [
        None if d is None else make_graph_arrays(params, rows, d) for d in devs
    ]
    return GraphArrays(**{
        name: RowShardedTable(
            [None if b is None else getattr(b, name) for b in per_block],
            rows, home, comm,
        )
        for name in GraphArrays._fields
    })


def _copy_rows(src: RowShardedTable, dst: RowShardedTable) -> None:
    """Copy every row of ``src`` into the same global rows of ``dst`` (as
    tall or taller, split into blocks of another height): block to block
    on the devices within one process; across processes through the host
    copy of ``src``."""
    host = src.cpu() if src.comm is not None else None
    n = src.shape[0]
    for s, blk in dst._local():
        lo, hi = s * dst.rows, min(n, (s + 1) * dst.rows)
        if host is not None:
            if lo < hi:
                blk[: hi - lo].copy_(host[lo:hi])
            continue
        for t, sb in enumerate(src.blocks):
            a, b = max(lo, t * src.rows), min(hi, (t + 1) * src.rows)
            if a < b:
                blk[a - lo : b - lo].copy_(sb[a - t * src.rows : b - t * src.rows])


def _medoid(arrays: GraphArrays) -> int:
    """``Coordinator.set_entry_to_medoid``'s slot over row-sharded tables:
    the same formula, with the mean's sum taken per block and the block
    sums added in block order (every process adds them the same way), and
    the argmin taken per block (ties to the smallest slot, as argmin)."""
    vecs, valid = arrays.vectors, arrays.valid
    sums = vecs.per_block(
        lambda v, va: torch.where(va[:, None], v.float(), 0.0).sum(0), valid
    )
    cnts = valid.per_block(lambda va: va.sum())
    total = functools.reduce(torch.add, sums)
    cnt = torch.clamp_min(functools.reduce(torch.add, cnts), 1).float()
    mean = total / cnt

    def block_min(v, va):
        d = ((v.float() - mean.to(v.device)[None, :]) ** 2).sum(-1)
        d = torch.where(va, d, torch.full_like(d, float("inf")))
        i = torch.argmin(d)
        return torch.stack([d[i].double(), i.double()])

    best = vecs.per_block(block_min, valid)
    pick = min(range(len(best)), key=lambda s: (float(best[s][0]), s))
    return pick * vecs.rows + int(best[pick][1])


def global_sharded_search(
    stacked: GraphArrays,  # row-sharded tables (RowShardedTable fields)
    queries: torch.Tensor,  # f32[B, D]
    entry_slot,  # int | i32[S] global seed slot(s)
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    beam_width: int = 1,
    assume_all_valid: bool = False,
):
    """The single-graph beam search over row-sharded tables: the port's
    unchanged ``beam_search``. Returns (topk_slots, topk_dists)."""
    res = beam_search(
        stacked, queries, entry_slot, params=params, l_search=l_search, k=k,
        beam_width=beam_width, assume_all_valid=assume_all_valid,
    )
    return res.topk_slots, res.topk_dists


class GlobalShardedIndex:
    """One LM-DiskANN graph whose tables are split by row over the mesh.

    Until ``distributed_build`` (or ``load_global_sharded``) the graph is
    the ``coordinator``'s own: DML runs there, and ``distribute()`` copies
    its tables into row blocks for ``search``. After a distributed build
    the Coordinator's tables ARE the row blocks (they never existed on one
    device), and every Coordinator workflow (insert, delete, update,
    vacuum, repair_reachability, search) runs on them unchanged. Answers
    and tables equal the single-device Coordinator's."""

    def __init__(self, coordinator: Coordinator, mesh=None):
        self.coordinator = coordinator
        self.mesh = mesh if mesh is not None else make_mesh()
        devs, self._comm = _blocks_of(self.mesh)
        self.n_shards = len(devs)
        self._stacked: GraphArrays | None = None
        # True once the Coordinator's own tables are row-sharded.
        self._distributed = False

    @property
    def params(self) -> GraphParams:
        return self.coordinator.params

    @property
    def last_search_stats(self):
        return self.coordinator.last_search_stats

    def _check_blocks(self, arrays: GraphArrays) -> None:
        devs, _ = _blocks_of(self.mesh)
        for name in GraphArrays._fields:
            for s, blk in enumerate(getattr(arrays, name).blocks):
                if blk is not None:
                    check_placement(blk, devs[s], f"row block {s} of {name}")

    # ---- DML: the Coordinator's own workflows ------------------------ #

    def insert(self, rowids, vectors) -> None:
        coord = self.coordinator
        if self._distributed:
            rowids = list(rowids)
            self._grow(coord.allocator.high_water + len(rowids))
        coord.insert(rowids, vectors)
        self._stacked = None

    def _grow(self, needed: int) -> None:
        """``Coordinator._ensure_capacity`` for row blocks: the capacity
        doubles until it holds ``needed`` rows, and every table is re-split
        into fresh blocks of the new height (global slots keep their
        numbers; only the block that holds them changes)."""
        coord = self.coordinator
        if needed <= coord.capacity:
            return
        new_cap = coord.capacity
        while new_cap < needed:
            new_cap *= 2
        old = coord.arrays
        coord.arrays = _alloc_stacked(coord.params, new_cap, self.mesh, coord.device)
        for name in GraphArrays._fields:
            _copy_rows(getattr(old, name), getattr(coord.arrays, name))
        grown = np.full(new_cap, INVALID_ROW_ID, np.int64)
        grown[: len(coord._slot_rowids)] = coord._slot_rowids
        coord._slot_rowids = grown

    def delete(self, rowids) -> int:
        n = self.coordinator.delete(rowids)
        self._stacked = None
        return n

    def update(self, rowid: int, vector) -> None:
        """Update = delete + re-insert (Coordinator::Update semantics)."""
        self.delete([int(rowid)])
        self.insert([int(rowid)], np.atleast_2d(np.asarray(vector)))

    def vacuum(self) -> int:
        n = self.coordinator.vacuum()
        self._stacked = None
        return n

    def repair_reachability(self, max_rounds: int = 8) -> int:
        n = self.coordinator.repair_reachability(max_rounds)
        self._stacked = None
        return n

    # ---- build straight into row blocks ------------------------------- #

    def distributed_build(
        self, rowids, vectors, max_batch: int = 1024, capacity: int = 0
    ) -> None:
        """Bulk-build the single graph into row blocks: the Coordinator's
        ``bulk_build`` (the same ramp, batches, reciprocal rounds and
        medoid entry) over freshly allocated row-sharded tables, so no
        device ever holds more than its blocks. The capacity is
        ``capacity`` or n, rounded up to a multiple of S; an insert past it
        re-splits the tables at twice the height (``_grow``)."""
        coord = self.coordinator
        if coord.count or self._distributed:
            raise RuntimeError("distributed_build requires an empty index")
        vectors = np.ascontiguousarray(np.atleast_2d(np.asarray(vectors)), np.float32)
        rowids = [int(r) for r in rowids]
        if vectors.shape[0] != len(rowids):
            raise ValueError("rowids/vectors length mismatch")
        S = self.n_shards
        cap = -(-max(len(rowids), capacity, S) // S) * S
        coord.arrays = _alloc_stacked(coord.params, cap, self.mesh, coord.device)
        coord._slot_rowids = np.full(cap, INVALID_ROW_ID, np.int64)
        self._distributed = True
        self._stacked = None
        old = coord.max_insert_batch
        coord.max_insert_batch = max_batch
        try:
            coord.insert(rowids, vectors)
        finally:
            coord.max_insert_batch = old
        self.set_entry_to_medoid()

    def set_entry_to_medoid(self) -> None:
        coord = self.coordinator
        if coord.count == 0:
            return
        slot = _medoid(self.distribute())
        if slot in coord.allocator.slot_to_rowid:
            coord.entry_slot = slot
            coord.entry_rowid = coord.allocator.slot_to_rowid[slot]

    # ---- search --------------------------------------------------------- #

    def distribute(self) -> GraphArrays:
        """The row-sharded tables: the Coordinator's own once distributed,
        else a row-blocked copy of them (capacity padded to a multiple of
        S), made once per state."""
        coord = self.coordinator
        if self._distributed:
            return coord.arrays
        if self._stacked is None:
            self._stacked = row_sharded_arrays(coord.arrays, self.mesh, coord.device)
            self._check_blocks(self._stacked)
        return self._stacked

    def search(
        self,
        queries: np.ndarray,
        k: int,
        l_search: int | None = None,
        beam_width: int = 1,
        n_seeds: int = 1,
        **options,
    ):
        """Exact single-graph top-k over the row blocks: the Coordinator's
        ``search`` (every option: ``batch_size``, ``stream``, filters,
        adaptive seeds, ...) on a view of the row-sharded tables. Returns
        (rowids i64[B, k], dists f32[B, k]), identical to
        ``Coordinator.search`` on the same state."""
        coord = self.coordinator
        if self._distributed:
            return coord.search(
                queries, k, l_search, beam_width, n_seeds, **options
            )
        L = max(l_search if l_search is not None else coord.config.l_search, k)
        stacked = self.distribute()
        sr = coord._slot_rowids
        if len(sr) < stacked.capacity:  # the padded rows map to no row
            sr = np.concatenate(
                [sr, np.full(stacked.capacity - len(sr), INVALID_ROW_ID, np.int64)]
            )
        view = coord.capture_view(min(n_seeds, L))._replace(
            arrays=stacked, slot_rowids=sr
        )
        return coord.search(
            queries, k, l_search, beam_width, n_seeds, view=view, **options
        )

    # ---- persistence ----------------------------------------------------- #

    def save(self, directory, chunk_bytes: int = 64 << 20) -> dict:
        """Checkpoint into a standard index directory (the single-device
        format: block_id == global slot), so it reopens on one device or
        row-sharded. One process: ``store.checkpoint.save_index`` reads the
        row blocks range by range. Several processes: each writes its own
        blocks and process 0 commits (``_save_multiprocess``); a graph
        every process holds whole is written by process 0 (the others
        return None)."""
        from ..store.checkpoint import save_index

        if self._comm is None:
            return save_index(self.coordinator, directory, chunk_bytes)
        if self._distributed:
            return self._save_multiprocess(directory)
        # Every process holds the whole replicated graph: process 0 writes.
        import torch.distributed as dist

        info = None
        if self._comm.rank == 0:
            info = save_index(self.coordinator, directory, chunk_bytes)
        dist.barrier()
        return info

    def _save_multiprocess(self, directory) -> dict:
        """Shard-parallel checkpoint (JAX ``_save_multiprocess``):

          1. process 0 creates the file at high-water length, marks it
             dirty and clears stale staged CRCs; barrier;
          2. every process encodes its own blocks' rows, stages their CRCs
             in the shared shadow store, then writes them at their offsets;
             barrier;
          3. process 0 rewrites the header, commits the staged CRCs with
             the allocator state and metadata, and marks the file clean;
             barrier.

        Always a full rewrite; needs a file system every process sees."""
        import torch.distributed as dist

        from ..store.block_codec import resolve_layout
        from ..store.checkpoint import _config_to_dict, encode_rows
        from ..store.file_service import open_block_file
        from ..store.shadow import ShadowStorageService

        coord = self.coordinator
        directory = Path(directory)
        layout = resolve_layout(coord.config)
        hw = coord.allocator.high_water
        first = self._comm.rank == 0
        if first:
            directory.mkdir(parents=True, exist_ok=True)
            bf = open_block_file(directory / "graph.lmd", layout.block_size, create=True)
            try:
                bf.mark_dirty(True)
                bf.truncate(hw)
                bf.sync()
            finally:
                bf.close()
            shadow = ShadowStorageService(directory)
            try:
                shadow.clear_staged_checksums()
            finally:
                shadow.close()
        dist.barrier()

        arrays = coord.arrays
        rows = arrays.vectors.rows
        written = 0
        bf = open_block_file(directory / "graph.lmd", layout.block_size, create=False)
        shadow = ShadowStorageService(directory)
        try:
            for s, _ in arrays.vectors._local():
                lo = s * rows
                n = min(hw - lo, rows)
                if n <= 0:
                    continue
                local = {
                    name: getattr(arrays, name).blocks[s][:n].cpu().numpy()
                    for name in GraphArrays._fields
                }
                blocks = encode_rows(coord, local)
                idx = np.arange(lo, lo + n, dtype=np.int64)
                shadow.stage_checksums(idx, bf.crc32_rows(blocks))
                bf.write_blocks_at(idx, blocks)
                written += n
            bf.sync()
        finally:
            bf.close()
            shadow.close()
        dist.barrier()

        if first:
            bf = open_block_file(directory / "graph.lmd", layout.block_size, create=False)
            try:
                bf.truncate(hw)
                bf.sync()
                shadow = ShadowStorageService(directory)
                try:
                    checksums = {
                        int(b): int(v)
                        for b, v in shadow.load_staged_checksums().items()
                    }
                    shadow.commit_checkpoint(
                        lookup=dict(coord.allocator.rowid_to_slot),
                        tombstones=coord.allocator.pending_deletion,
                        checksums=checksums,
                        metadata={
                            "format_version": 3,
                            "config": _config_to_dict(coord.config),
                            "entry_rowid": coord.entry_rowid,
                            "count": coord.count,
                            "high_water": hw,
                            "free_slots": coord.allocator.free_slots,
                            "broken": False,
                        },
                        incremental=False,
                    )
                finally:
                    shadow.close()
                bf.mark_dirty(False)
            finally:
                bf.close()
        dist.barrier()
        arrays.dirty_rows.zero_()
        coord.dirty = False
        return {"blocks_written": written, "incremental": False, "high_water": hw}


def load_global_sharded(
    directory, mesh=None, verify_checksums: bool = True, device=None
) -> GlobalShardedIndex:
    """Load a checkpoint straight into row blocks: the host decodes the
    file, and each block's rows are copied to its shard's device only
    (across processes, only this process's blocks). Any directory saved by
    ``save_index`` or ``GlobalShardedIndex.save`` opens here. ``device``
    is the Coordinator's device (default: the first of this process's
    shard devices)."""
    from ..store.checkpoint import _load_host_state, _restore_coordinator_meta

    mesh = mesh if mesh is not None else make_mesh()
    devs, comm = _blocks_of(mesh)
    S = len(devs)
    home = torch.device(
        device if device is not None else next(d for d in devs if d is not None)
    )
    st = _load_host_state(directory, verify_checksums)
    hw = st["hw"]
    # load_index's capacity, rounded up to a multiple of S
    cap = -(-max(1024, hw) // S) * S
    coord = Coordinator(st["config"], device=home)
    coord.arrays = _alloc_stacked(coord.params, cap, mesh, home)
    rows = cap // S
    for name, host in st["fields"].items():
        table = getattr(coord.arrays, name)
        for s, blk in table._local():
            lo = s * rows
            n = min(hw - lo, rows)
            if n > 0:
                blk[:n].copy_(torch.from_numpy(host[lo : lo + n]))
    gidx = GlobalShardedIndex(coord, mesh=mesh)
    gidx._distributed = True
    gidx._check_blocks(coord.arrays)
    # The fallback reads the placed tables: it runs after the allocator
    # state is restored.
    _restore_coordinator_meta(
        coord, st, cap, entry_fallback=coord._select_fallback_entry
    )
    return gidx
