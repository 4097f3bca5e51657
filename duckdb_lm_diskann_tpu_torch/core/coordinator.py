"""Coordinator: the host-side owner of one index — graph tensors on a
device, the rowid<->slot map, the entry point — and its insert and search
workflows.

Counterpart of ``duckdb_lm_diskann_tpu/core/coordinator.py`` for the build
and search path: ``insert`` (bootstrap node, then batches that ramp with
the graph size), ``bulk_build`` (+ medoid entry point) and ``search`` with
the JAX package's serving options (beam width, seed sets, filters, read
views, pipelined batches, adaptive seeds, streaming lanes). The index
lives on the card: ``Coordinator(config, capacity)`` keeps every tensor on
CUDA and raises if CUDA is not available; ``device="cpu"`` asks for the
CPU (the tests do, with the kernels' plain versions).

Edge codecs: INT4, TERNARY and INT8, including ``edge_type=None``, which
resolves to the reference's defaults (TERNARY for COSINE/IP, INT8 for L2).
The others raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..common.types import INVALID_ROW_ID
from ..utils.tracing import SearchStats
from .builder import insert_batch, require_ported_codec
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
)

_MIN_CAPACITY = 1024


class ReadView(NamedTuple):
    """The handles one search reads. The tensors are the live ones: the
    builder writes them in place, so a view is not isolated from later
    inserts (snapshot reads are later work, ROADMAP queue 1, item 9)."""

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
        require_ported_codec(self.params)
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
        self.max_insert_batch: int = 1024
        # (batch_rows, seconds) per insert batch, bounded.
        self.build_timings: list[tuple[int, float]] = []
        # True once any slot was tombstoned (a failed insert's rollback);
        # until then every edge target is live and searches skip the
        # neighbor-validity gather.
        self._ever_tombstoned: bool = False
        self.last_search_stats: SearchStats | None = None

    @property
    def count(self) -> int:
        return self.allocator.count

    @property
    def capacity(self) -> int:
        return self.arrays.capacity

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
        """Insert a batch of (rowid, vector) pairs."""
        vectors = np.atleast_2d(np.asarray(vectors))
        rowids = [int(r) for r in rowids]
        if len(rowids) != vectors.shape[0]:
            raise ValueError("rowids/vectors length mismatch")
        if vectors.shape[1] != self.config.dimensions:
            raise ValueError(
                f"vector dimensions {vectors.shape[1]} != index dimensions "
                f"{self.config.dimensions}"
            )
        vectors = np.ascontiguousarray(vectors, np.float32)
        self._ensure_capacity(self.allocator.high_water + len(rowids))
        graph_size = self.count  # nodes already connected into the graph
        slots = self.allocator.allocate_batch(rowids)
        try:
            offset = 0
            # The very first node bootstraps alone (entry point, no edges).
            if self.entry_slot < 0 and len(slots):
                insert_batch(self.arrays, slots[:1], vectors[:1], -1, self.params)
                self.entry_slot = int(slots[0])
                self.entry_rowid = rowids[0]
                offset = 1
                graph_size = 1
            while offset < len(slots):
                # A batch searches the pre-batch graph, so its width never
                # exceeds the graph size: this ramps 1, 1, 2, 4, ...
                step = min(len(slots) - offset, graph_size, self.max_insert_batch)
                t0 = time.perf_counter()
                insert_batch(
                    self.arrays,
                    slots[offset : offset + step],
                    vectors[offset : offset + step],
                    self.entry_slot,
                    self.params,
                    all_valid=not self._ever_tombstoned,
                )
                self.build_timings.append((step, time.perf_counter() - t0))
                if len(self.build_timings) > 8192:
                    del self.build_timings[:4096]
                offset += step
                graph_size += step
        except Exception:
            # Rollback (Coordinator.cpp:160-172) as far as in-place writes
            # allow: the batch's slots leave the live mask and go to the
            # deletion queue. Edges already written into older rows stay,
            # as zombies that the validity mask filters from now on.
            touched = [
                self.allocator.rowid_to_slot[r]
                for r in rowids
                if r in self.allocator.rowid_to_slot
            ]
            if touched:
                self._ever_tombstoned = True
                idx = torch.as_tensor(touched, device=self.device)
                self.arrays.valid[idx] = False
            for r in rowids:
                if r in self.allocator.rowid_to_slot:
                    self.allocator.free(r)
            # A rolled-back bootstrap node leaves the graph empty.
            if (
                self.entry_slot >= 0
                and self.entry_rowid not in self.allocator.rowid_to_slot
            ):
                self.entry_slot, self.entry_rowid = -1, INVALID_ROW_ID
            raise
        sr = self._slot_rowids.copy()
        sr[slots] = np.asarray(rowids, np.int64)
        self._slot_rowids = sr

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
            assume_all_valid=not view.ever_tombstoned,
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
            slots = res.topk_slots.cpu().numpy()
            dists = res.topk_dists.cpu().numpy()
            visited = int(res.visited_count.sum())
            hops = int(res.hops)
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
