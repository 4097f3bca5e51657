"""Coordinator: the host-side owner of one index — graph tensors on a
device, the rowid<->slot map, the entry point — and its workflows.

Counterpart of ``duckdb_lm_diskann_tpu/core/coordinator.py``:

  * build and search: ``insert`` (bootstrap node, then batches that ramp
    with the graph size; a failed batch rolls back exactly), ``bulk_build``
    (+ medoid entry point), ``refine`` (the post-build Vamana second pass)
    and ``search`` with the JAX package's serving options (beam width, seed
    sets, filters, read views, pipelined batches, adaptive seeds, streaming
    lanes);
  * the lifecycle: ``delete`` (eager back-edge repair and orphan rescue),
    ``update``, ``vacuum`` (slot recycling + ``repair_reachability``),
    ``snapshot`` (a read-only copy), ``handle_commit_drop`` and
    ``get_in_memory_size``;
  * persistence hooks: an injected ``shadow_service`` logs every committed
    insert batch and delete (store/shadow.py, store/checkpoint.py).

The index lives on the card: ``Coordinator(config, capacity)`` keeps every
tensor on CUDA and raises if CUDA is not available; ``device="cpu"`` asks
for the CPU (the tests do, with the kernels' plain versions). Every edge
codec and both node-vector types (FLOAT32, INT8) are supported, within the
metric rules of ``LmDiskannConfig.validate``; ``edge_type=None`` resolves
to the reference's defaults (TERNARY for COSINE/IP, INT8 for L2).

Mutations write the graph tensors in place. With ``donate_buffers`` False
(the JAX package's switch for concurrent readers) each mutation writes
into copies of the tables it touches and rebinds ``arrays`` at its end, so
a ``ReadView`` captured earlier never changes.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..common.types import INVALID_ROW_ID
from ..utils import tracing
from ..utils.tracing import SearchStats
from .builder import (
    UndoJournal,
    batched_robust_prune,
    choose_adopters,
    delete_repair_round,
    force_edge_lists,
    insert_batch,
    plan_delete_repair,
    reachable_mask,
    refresh_edge_codes,
    rescue_orphans_round,
    select_fallback_entry,
    write_neighbor_rows,
)
from .config import LmDiskannConfig
from .graph import (
    GraphArrays,
    GraphParams,
    SlotAllocator,
    grow_graph_arrays,
    make_graph_arrays,
)
from .searcher import (
    beam_search,
    beam_search_many,
    beam_search_stream,
    pick_adaptive_seeds,
    search_for_initial_candidates,
)

_MIN_CAPACITY = 1024

# The tables each kind of mutation writes (copied first while
# donate_buffers is False).
_EDGE_FIELDS = (
    "edge_pos", "edge_neg", "edge_i8", "edge_i4", "edge_scale", "edge_f32",
)
_RELINK_FIELDS = ("neighbors", "dirty_rows") + _EDGE_FIELDS
_DELETE_FIELDS = _RELINK_FIELDS + ("valid",)
_INSERT_FIELDS = GraphArrays._fields


class ReadView(NamedTuple):
    """The handles one search reads. A view is a point-in-time state while
    the Coordinator's ``donate_buffers`` is False: mutations then write into
    copies and leave the view's tensors as they were. With donation on (the
    default, as in the JAX package) mutations write the view's tensors in
    place, so a view must not outlive the next mutation."""

    arrays: GraphArrays
    entry_slot: int
    seeds: np.ndarray  # i32[S]
    slot_rowids: np.ndarray  # i64[capacity]
    count: int
    ever_tombstoned: bool


class Coordinator:
    """Owns the index state and implements insert / bulk build / search."""

    def __init__(
        self,
        config: LmDiskannConfig,
        initial_capacity: int = _MIN_CAPACITY,
        device="cuda",
    ):
        self.params = GraphParams.from_config(config)  # validates
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Coordinator(device='cuda'): CUDA is not available")
        self.config = config
        self.allocator = SlotAllocator()
        # Power-of-two capacities, grown by doubling (as in the JAX package).
        capacity = _MIN_CAPACITY
        while capacity < initial_capacity:
            capacity *= 2
        self.arrays: GraphArrays = make_graph_arrays(
            self.params, capacity, self.device
        )
        self.entry_slot: int = -1
        self.entry_rowid: int = INVALID_ROW_ID
        self._slot_rowids = np.full(capacity, INVALID_ROW_ID, np.int64)
        # Written since the last checkpoint; a mutation since the last
        # reachability repair (vacuum repairs only then).
        self.dirty: bool = False
        self._needs_reachability_repair: bool = False
        # Nodes the last repair_reachability relinked (vacuum runs one).
        self.last_relinked: int = 0
        self.max_insert_batch: int = 1024
        # True once any slot was tombstoned (a delete, a failed insert's
        # rollback); until then every edge target is live and searches skip
        # the neighbor-validity gather. Never cleared: zombie in-edges into
        # recycled slots can persist.
        self._ever_tombstoned: bool = False
        self.last_search_stats: SearchStats | None = None
        # False while readers hold ReadViews: mutations then write copies
        # (see _writable), the JAX package's non-donating twins.
        self.donate_buffers: bool = True
        # The delta log of the index's directory (store/shadow.py's
        # ShadowStorageService), injected by the db layer: every committed
        # insert batch and delete is logged, so a reopened index can replay
        # what its last checkpoint missed (store/checkpoint.recover).
        self.shadow_service = None

    @property
    def count(self) -> int:
        return self.allocator.count

    @property
    def capacity(self) -> int:
        return self.arrays.capacity

    def get_in_memory_size(self) -> int:
        """Bytes of the graph tensors (Coordinator::GetInMemorySize,
        Coordinator.cpp:370-389)."""
        return sum(t.numel() * t.element_size() for t in self.arrays)

    # ------------------------------------------------------------------ #
    # snapshots and copies

    def snapshot(self) -> "Coordinator":
        """A read-only copy of the index as it is now: its tensors are
        cloned on the same device, so searches on it never see later
        inserts, deletes or slot recycling of this index. Mutating it
        raises."""
        snap = Coordinator.__new__(Coordinator)
        snap.__dict__.update(self.__dict__)
        snap.allocator = self.allocator.copy()
        snap.arrays = GraphArrays(*(t.clone() for t in self.arrays))
        snap._slot_rowids = self._slot_rowids.copy()
        snap.dirty = False
        snap._needs_reachability_repair = False
        snap.last_search_stats = None
        snap.donate_buffers = False
        snap.shadow_service = None
        snap._frozen = True
        return snap

    def _check_mutable(self) -> None:
        if getattr(self, "_frozen", False):
            raise RuntimeError("index snapshot is read-only")

    def _writable(self, fields: Sequence[str]) -> GraphArrays:
        """The arrays a mutation writes: the live ones, or, while
        ``donate_buffers`` is False, the live ones with each of ``fields``
        copied. The mutation rebinds ``self.arrays`` to them at its end."""
        if self.donate_buffers:
            return self.arrays
        return self.arrays._replace(
            **{f: getattr(self.arrays, f).clone() for f in fields}
        )

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        self.arrays = grow_graph_arrays(self.arrays, new_cap)
        grown = np.full(new_cap, INVALID_ROW_ID, np.int64)
        grown[: len(self._slot_rowids)] = self._slot_rowids
        self._slot_rowids = grown

    # ------------------------------------------------------------------ #
    # insert (Coordinator::Insert, Coordinator.cpp:104-174)

    def insert(self, rowids: Sequence[int], vectors: np.ndarray) -> None:
        """Insert a batch of (rowid, vector) pairs. If a batch step fails,
        its writes are undone, every row of the call leaves the live mask
        and the allocator (its slots wait in the deletion queue), and the
        error is raised."""
        rec = tracing.recorder("insert", rows=len(rowids))
        try:
            self._check_mutable()
            vectors = np.atleast_2d(np.asarray(vectors))
            rowids = [int(r) for r in rowids]
            if len(rowids) != vectors.shape[0]:
                raise ValueError("rowids/vectors length mismatch")
            if vectors.shape[1] != self.config.dimensions:
                raise ValueError(
                    f"vector dimensions {vectors.shape[1]} != index dimensions "
                    f"{self.config.dimensions}"
                )
            # Compute flows in f32; store_vectors quantizes back to the storage
            # dtype (INT8 node vectors: round + clamp).
            vectors = np.ascontiguousarray(vectors, np.float32)
            self._ensure_capacity(self.allocator.high_water + len(rowids))
            graph_size = self.count  # nodes already connected into the graph
            slots = self.allocator.allocate_batch(rowids)
            arrays = self._writable(_INSERT_FIELDS)
            try:
                offset = 0
                # The very first node bootstraps alone (entry point, no edges).
                if self.entry_slot < 0 and len(slots):
                    self._insert_step(
                        arrays, slots[:1], vectors[:1], -1, False, rec
                    )
                    self.entry_slot = int(slots[0])
                    self.entry_rowid = rowids[0]
                    offset = 1
                    graph_size = 1
                while offset < len(slots):
                    # A batch searches the pre-batch graph, so its width never
                    # exceeds the graph size: this ramps 1, 1, 2, 4, ...
                    step = min(
                        len(slots) - offset, graph_size, self.max_insert_batch
                    )
                    if rec is not None:
                        rec.open("insert.step", rows=step)
                    self._insert_step(
                        arrays,
                        slots[offset : offset + step],
                        vectors[offset : offset + step],
                        self.entry_slot,
                        not self._ever_tombstoned,
                        rec,
                    )
                    if rec is not None:
                        rec.close()
                    offset += step
                    graph_size += step
            except Exception:
                # Rollback FreeNode on error (Coordinator.cpp:160-172): the
                # failed step's writes are already undone (_insert_step); the
                # call's earlier batches leave the live mask, and their slots
                # wait in the deletion queue for vacuum, as any delete's do.
                touched = [
                    self.allocator.rowid_to_slot[r]
                    for r in rowids
                    if r in self.allocator.rowid_to_slot
                ]
                if touched:
                    self._ever_tombstoned = True
                    idx = torch.as_tensor(touched, device=self.device)
                    arrays.valid[idx] = False
                for r in rowids:
                    if r in self.allocator.rowid_to_slot:
                        self.allocator.free(r)
                self.arrays = arrays
                # A rolled-back entry point: fall back to a live node, or leave
                # the graph empty (the next insert bootstraps again).
                if (
                    self.entry_slot >= 0
                    and self.entry_rowid not in self.allocator.rowid_to_slot
                ):
                    self.entry_slot, self.entry_rowid = (
                        self._select_fallback_entry()
                    )
                raise
            self.arrays = arrays
            # Copy-on-write: live ReadViews keep the pre-mutation table.
            sr = self._slot_rowids.copy()
            sr[slots] = np.asarray(rowids, np.int64)
            self._slot_rowids = sr
            # Only a committed batch is logged: a rolled-back insert raised above.
            if self.shadow_service is not None:
                self.shadow_service.log_insert_batch(rowids, slots.tolist())
            self.dirty = True
            self._needs_reachability_repair = True
        finally:
            tracing.end(rec)

    def _insert_step(self, arrays, slots, vectors, entry_slot, all_valid, rec):
        """One insert_batch call whose writes are journaled: on failure
        every row it wrote is restored before the error propagates."""
        journal = UndoJournal()
        try:
            insert_batch(
                arrays, slots, vectors, entry_slot, self.params,
                all_valid=all_valid, journal=journal, rec=rec,
            )
        except Exception:
            journal.rollback()
            raise

    def bulk_build(
        self,
        rowids: Sequence[int],
        vectors: np.ndarray,
        max_batch: int = 1024,
    ) -> None:
        """CREATE INDEX bulk path: ramped batched insertion, then the medoid
        becomes the entry point."""
        old = self.max_insert_batch
        self.max_insert_batch = max_batch
        try:
            self.insert(rowids, np.atleast_2d(vectors))
        finally:
            self.max_insert_batch = old
        self.set_entry_to_medoid()

    def set_entry_to_medoid(self) -> None:
        """Move the entry point to the live node closest to the dataset
        mean (the classic DiskANN entry choice)."""
        if self.count == 0:
            return
        valid = self.arrays.valid
        vecs = self.arrays.vectors.float()
        cnt = torch.clamp_min(valid.sum(), 1).float()
        mean = torch.where(valid[:, None], vecs, 0.0).sum(0) / cnt
        d = ((vecs - mean[None, :]) ** 2).sum(-1)
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        slot = int(torch.argmin(d))
        if slot in self.allocator.slot_to_rowid:
            self.entry_slot = slot
            self.entry_rowid = self.allocator.slot_to_rowid[slot]

    def refine(self, max_batch: int | None = None, repair: bool = True) -> int:
        """Post-build refine pass, the Vamana second pass: every live node,
        in batches in slot order, re-searches the current graph for its
        L_insert candidates and re-prunes its out-edges over (its neighbors
        plus the visited set). Re-pruning can evict a node's last in-link,
        so ``repair`` then runs repair_reachability. Returns the rows
        refined."""
        self._check_mutable()
        if self.count < 2 or self.entry_slot < 0:
            return 0
        mb = max_batch or self.max_insert_batch
        live = np.asarray(sorted(self.allocator.slot_to_rowid), np.int32)
        all_valid = not self._ever_tombstoned
        arrays = self._writable(_RELINK_FIELDS)
        for off in range(0, len(live), mb):
            slots = torch.as_tensor(live[off : off + mb], device=self.device)
            vecs = arrays.vectors[slots.long()].float()
            res = search_for_initial_candidates(
                arrays, vecs, self.entry_slot, params=self.params,
                l_insert=self.config.l_insert,
                beam_width=self.params.insert_beam_width,
                assume_all_valid=all_valid,
            )
            cands = torch.cat(
                [arrays.neighbors[slots.long()], res.visited_slots], 1
            )
            sel = batched_robust_prune(
                arrays, vecs, cands, slots, params=self.params
            )
            write_neighbor_rows(arrays, slots, sel, params=self.params)
        self.arrays = arrays
        self.dirty = True
        self._needs_reachability_repair = True
        if repair:
            self.repair_reachability()
        return len(live)

    # ------------------------------------------------------------------ #
    # search (Coordinator::Search, Coordinator.cpp:63-102)

    def _seed_slots(self, n_seeds: int) -> np.ndarray:
        """Pinned seed set: the entry point plus (n-1) live slots stratified
        over insertion order."""
        if n_seeds <= 1:
            return np.asarray([self.entry_slot], np.int32)
        live = sorted(self.allocator.slot_to_rowid)
        if not live:
            return np.asarray([self.entry_slot], np.int32)
        picks = [self.entry_slot]
        step = max(len(live) // n_seeds, 1)
        for i in range(n_seeds - 1):
            picks.append(live[(i * step + step // 2) % len(live)])
        return np.asarray(picks, np.int32)

    def capture_view(self, n_seeds: int = 1) -> ReadView:
        return ReadView(
            arrays=self.arrays,
            entry_slot=self.entry_slot,
            seeds=self._seed_slots(n_seeds),
            slot_rowids=self._slot_rowids,
            count=self.count,
            ever_tombstoned=self._ever_tombstoned,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int,
        l_search: int | None = None,
        beam_width: int = 1,
        n_seeds: int = 1,
        allowed_rowids: np.ndarray | None = None,
        view: ReadView | None = None,
        batch_size: int | None = None,
        adaptive_seeds: int = 0,
        seed_sample: int = 4096,
        stream: bool = False,
        lanes: int = 1024,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k search, with the JAX package's parameters in its
        order (its last one, ``pad_to_bucket``, exists for XLA's static
        shapes and is not ported). Returns (rowids i64[B, k], dists
        f32[B, k]); empty results are (-1, +inf).

        ``beam_width``: nodes visited per hop (E). ``n_seeds``: the entry
        point plus stratified live seeds. ``allowed_rowids`` restricts the
        RESULTS to those rows (traversal still routes through every node).
        ``view``: search a captured ReadView instead of the live state.

        ``batch_size``: when set and B > batch_size, the queries run as
        ceil(B / batch_size) lock-step batches through beam_search_many;
        the last is padded with repeats of query 0, whose results are
        discarded. ``last_search_stats`` then sums ``hops`` over every
        batch (pad lanes can extend the last one) and counts visits over
        the B real lanes only, as the JAX package does.

        ``adaptive_seeds``: when > 0, each query's beam is seeded with its
        ``adaptive_seeds`` nearest nodes among a ``seed_sample``-node
        stratified live sample (pick_adaptive_seeds); overrides ``n_seeds``.

        ``stream``: run through beam_search_stream, ``lanes`` lanes refilled
        from the query queue as they converge (beam_width must be 1)."""
        rec = tracing.recorder("search", k=k)
        try:
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            if queries.shape[1] != self.config.dimensions:
                raise ValueError(
                    f"query dimensions {queries.shape[1]} != index dimensions "
                    f"{self.config.dimensions}"
                )
            if batch_size is not None and batch_size < 1:
                raise ValueError(f"batch_size must be >= 1, got {batch_size}")
            B = queries.shape[0]
            # L_search = max(explicit param or config default, k)
            # (Coordinator.cpp:63-102 / Searcher::Search :256-272).
            L = max(l_search if l_search is not None else self.config.l_search, k)
            if rec is not None:
                rec.set(queries=B, l_search=L)
            if view is None:
                view = self.capture_view(min(n_seeds, L))
            if view.count == 0 or view.entry_slot < 0:
                return (
                    np.full((B, k), INVALID_ROW_ID, np.int64),
                    np.full((B, k), np.inf, np.float32),
                )
            # As the JAX package: an empty index answers any beam_width first.
            if stream and beam_width != 1:
                raise ValueError("stream search supports beam_width=1 only")
            dev = view.arrays.device
            seeds = view.seeds
            allowed = None
            if allowed_rowids is not None:
                # Slot mask: a slot is allowed iff its rowid is in the set.
                allowed = torch.as_tensor(
                    np.isin(
                        view.slot_rowids[: view.arrays.capacity],
                        np.asarray(allowed_rowids, np.int64),
                    ),
                    device=dev,
                )
            opts = dict(
                params=self.params, l_search=L, k=k, allowed=allowed,
                assume_all_valid=not view.ever_tombstoned, rec=rec,
            )
            t0 = time.perf_counter()
            if batch_size is not None and B > batch_size and not stream:
                # Pad B to a multiple of batch_size with repeats of query 0.
                nb = -(-B // batch_size)
                padded = np.broadcast_to(
                    queries[:1], (nb * batch_size, queries.shape[1])
                ).copy()
                padded[:B] = queries
                q_dev = torch.as_tensor(padded, device=dev)
                entry = self._entry(view, q_dev, adaptive_seeds, seed_sample, L)
                if adaptive_seeds > 0:
                    entry = entry.reshape(nb, batch_size, -1)
                mres = beam_search_many(
                    view.arrays, q_dev.reshape(nb, batch_size, -1), entry,
                    beam_width=beam_width, **opts,
                )
                if rec is not None:
                    rec.open("search.readback")
                slots = mres.topk_slots.reshape(-1, k)[:B].cpu().numpy()
                dists = mres.topk_dists.reshape(-1, k)[:B].cpu().numpy()
                visited = int(mres.visited_count.reshape(-1)[:B].sum())
                hops = int(mres.hops.sum())
            else:
                q_dev = torch.as_tensor(queries, device=dev)
                entry = self._entry(view, q_dev, adaptive_seeds, seed_sample, L)
                if stream:
                    res = beam_search_stream(
                        view.arrays, q_dev, entry, lanes=lanes, **opts
                    )
                else:
                    res = beam_search(
                        view.arrays, q_dev, entry, beam_width=beam_width, **opts
                    )
                if rec is not None:
                    rec.open("search.readback")
                slots = res.topk_slots.cpu().numpy()
                dists = res.topk_dists.cpu().numpy()
                visited = int(res.visited_count.sum())
                hops = int(res.hops)
            if rec is not None:
                rec.close()
            wall = time.perf_counter() - t0  # after the device results are read
            self.last_search_stats = SearchStats(
                queries=B,
                hops=hops,
                nodes_visited=visited,
                l_search=L,
                k=k,
                # R edge-code scores + 1 exact per visit, plus the seed scores.
                distance_ops=visited * (self.params.r + 1) + B * len(seeds),
                wall_time_s=wall,
            )
            rowids = np.where(
                slots >= 0,
                view.slot_rowids[np.maximum(slots, 0)],
                INVALID_ROW_ID,
            )
            return rowids, dists
        finally:
            tracing.end(rec)

    def _entry(
        self,
        view: ReadView,
        q_dev: torch.Tensor,
        adaptive_seeds: int,
        seed_sample: int,
        l_search: int,
    ) -> torch.Tensor:
        """The search's seeds: the view's pinned set i32[S], or per-query
        adaptive seeds i32[B, S] when ``adaptive_seeds`` > 0."""
        if adaptive_seeds > 0:
            return self._pick_adaptive(
                view, q_dev, adaptive_seeds, seed_sample, l_search
            )
        return torch.as_tensor(view.seeds, device=view.arrays.device)

    def _pick_adaptive(
        self,
        view: ReadView,
        q_dev: torch.Tensor,
        s_count: int,
        seed_sample: int,
        l_search: int,
    ) -> torch.Tensor:
        """Per-query adaptive seeds i32[B, S]: the nearest of a stratified
        live sample (searcher.pick_adaptive_seeds)."""
        cap = view.arrays.capacity
        live = np.nonzero(view.slot_rowids[:cap] != INVALID_ROW_ID)[0]
        m = max(min(seed_sample, len(live)), 1)
        # Even coverage over the WHOLE live range: live[(i*len)//m], so the
        # insertion-order tail (whole clusters, on clustered corpora) is
        # sampled too.
        sample = live[(np.arange(m, dtype=np.int64) * len(live)) // m]
        return pick_adaptive_seeds(
            view.arrays.vectors,
            q_dev,
            torch.as_tensor(sample.astype(np.int32), device=view.arrays.device),
            metric=self.params.metric,
            s_count=max(1, min(s_count, len(sample), l_search)),
        )

    # ------------------------------------------------------------------ #
    # delete / update / vacuum (Coordinator.cpp:176-237, :319-368)

    def delete(self, rowids: Sequence[int], on_phase=None) -> int:
        """Delete rows; missing rowids are skipped (vectordiskann.c:
        1646-1650). Returns the number of rows deleted.

        Each live neighbor of a deleted node re-prunes its list plus the
        deleted node's out-edges with every deleted slot masked out (round k
        repairs each target against its k-th adjacent deleted node); then
        the rows are tombstoned, and any affected node left with no in-link
        is force-linked from its nearest live ex-sibling. Edges into a
        deleted row from elsewhere stay as zombies that the validity mask
        filters. A dead entry point falls back to the live slot with the
        most live out-neighbors.

        ``on_phase(name)``, when given, is called at the end of each phase:
        "plan", "repair_rounds", "tombstone", "rescue", "refresh" (those two
        only when a live node was adjacent) and "bookkeeping"
        (experiments/profile_delete.py times them)."""
        self._check_mutable()
        phase = on_phase or (lambda name: None)
        seen: set[int] = set()
        present = [
            r
            for r in (int(x) for x in rowids)
            if r in self.allocator.rowid_to_slot
            and not (r in seen or seen.add(r))
        ]
        if not present:
            return 0
        del_slots = np.asarray(
            [self.allocator.rowid_to_slot[r] for r in present], np.int32
        )
        arrays = self._writable(_DELETE_FIELDS)
        dev = self.device
        del_dev = torch.as_tensor(del_slots, device=dev)
        nbr_rows = arrays.neighbors[del_dev.long()].cpu().numpy()
        rounds, rescue = plan_delete_repair(nbr_rows, del_slots, self.params.r)
        phase("plan")
        for tgt, extra in rounds:
            delete_repair_round(
                arrays,
                torch.as_tensor(tgt, device=dev),
                torch.as_tensor(extra, device=dev),
                del_dev,
                params=self.params,
            )
        phase("repair_rounds")
        # Tombstone + unmap + enqueue (EnqueueDeletion + FreeNode).
        self._ever_tombstoned = True
        arrays.valid[del_dev.long()] = False
        arrays.dirty_rows[del_dev.long()] = True
        phase("tombstone")
        if rescue is not None:
            tgt, sibs = rescue
            _, adopters = rescue_orphans_round(
                arrays,
                torch.as_tensor(tgt, device=dev),
                torch.as_tensor(sibs, device=dev),
                del_dev,
                params=self.params,
            )
            phase("rescue")
            refresh_edge_codes(arrays, adopters, params=self.params)
            phase("refresh")
        self.arrays = arrays
        for r in present:
            self.allocator.free(r)
        # Copy-on-write: live ReadViews keep the pre-mutation table.
        sr = self._slot_rowids.copy()
        sr[del_slots] = INVALID_ROW_ID
        self._slot_rowids = sr
        if self.shadow_service is not None:
            self.shadow_service.log_delete_batch(present)
        if self.entry_slot in set(del_slots.tolist()):
            self.entry_slot, self.entry_rowid = self._select_fallback_entry()
        self.dirty = True
        self._needs_reachability_repair = True
        phase("bookkeeping")
        return len(present)

    def _select_fallback_entry(self) -> tuple[int, int]:
        """Deterministic entry re-selection after the entry point dies
        (builder.select_fallback_entry)."""
        return select_fallback_entry(
            self.allocator.slot_to_rowid,
            self.arrays.neighbors.cpu().numpy(),
            self.arrays.valid.cpu().numpy(),
        )

    def update(self, rowid: int, vector: np.ndarray) -> None:
        """Update = delete + re-insert (Coordinator::Update, :226-237)."""
        self._check_mutable()
        self.delete([rowid])
        self.insert([rowid], np.atleast_2d(vector))

    def vacuum(self) -> int:
        """PerformVacuum -> ProcessDeletionQueue (Coordinator.cpp:353-368):
        recycle the tombstoned slots into the free list, then repair
        reachability if the graph changed since the last repair. Returns
        the slots recycled."""
        self._check_mutable()
        recycled = self.allocator.process_deletion_queue()
        self.dirty = self.dirty or bool(recycled)
        if self._needs_reachability_repair:
            self.repair_reachability()
        return len(recycled)

    def repair_reachability(self, max_rounds: int = 8) -> int:
        """Force an in-link for every live node unreachable from the entry
        point. Each round: a host BFS over live out-edges, one beam search
        for the stranded nodes' nearest reachable nodes (a beam search only
        returns reachable nodes), one force-link pass into distinct
        adopters. A relinked island member exposes its island to the next
        round, and a force-link into a full row can strand another node, so
        the rounds run to a fixpoint (at most ``max_rounds``). Returns the
        nodes relinked."""
        self._check_mutable()
        if self.count < 2 or self.entry_slot < 0:
            self._needs_reachability_repair = False
            self.last_relinked = 0
            return 0
        arrays = self.arrays
        copied = False
        total = 0
        dev = self.device
        for _ in range(max_rounds):
            nbrs_h = arrays.neighbors.cpu().numpy()
            valid_h = arrays.valid.cpu().numpy()
            reach = reachable_mask(nbrs_h, valid_h, self.entry_slot)
            orphans = np.nonzero(valid_h & ~reach)[0].astype(np.int32)
            if len(orphans) == 0:
                break
            o_dev = torch.as_tensor(orphans, device=dev)
            res = beam_search(
                arrays, arrays.vectors[o_dev.long()].float(), self.entry_slot,
                params=self.params, l_search=max(16, self.params.r), k=4,
            )
            adopters = choose_adopters(
                orphans, res.topk_slots.cpu().numpy(), nbrs_h, len(orphans)
            )
            n_adopted = int((adopters >= 0).sum())
            if n_adopted == 0:
                break  # no orphan could be adopted; further rounds stall
            total += n_adopted
            if not copied:
                arrays, copied = self._writable(_RELINK_FIELDS), True
            a_dev = torch.as_tensor(adopters, device=dev)
            force_edge_lists(
                arrays.vectors, arrays.neighbors, a_dev,
                torch.where(a_dev >= 0, o_dev, -1), self.params,
            )
            arrays.dirty_rows[a_dev[a_dev >= 0].long()] = True
            refresh_edge_codes(arrays, a_dev, params=self.params)
            self.dirty = True
        self.arrays = arrays
        self._needs_reachability_repair = False
        self.last_relinked = total
        return total

    def handle_commit_drop(self) -> None:
        """HandleCommitDrop (Coordinator.cpp:319-351): drop all state."""
        self.allocator = SlotAllocator()
        self.arrays = make_graph_arrays(self.params, _MIN_CAPACITY, self.device)
        self._slot_rowids = np.full(_MIN_CAPACITY, INVALID_ROW_ID, np.int64)
        self.entry_slot = -1
        self.entry_rowid = INVALID_ROW_ID
        self.dirty = False
