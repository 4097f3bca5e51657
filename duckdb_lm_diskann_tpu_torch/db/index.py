"""LmDiskannIndex: the bound-index adapter + scan state.

TPU-native re-design of ``db::LmDiskannIndex`` (src/lm_diskann/db/
LmDiskannIndex.{hpp,cpp}), the DuckDB BoundIndex adapter that:

  - parses WITH (METRIC, R, L_INSERT, ALPHA, L_SEARCH) options (:72-110)
  - derives dims + vector dtype from the ARRAY column type (:137-154)
  - computes the layout + sector-aligned block size (:160-162)
  - creates the per-index directory ``<db>.lmd_idx/<index>/`` (:165-235)
  - wires up the Coordinator with injected services (:170-190)
  - forwards Append/Insert/Delete/Vacuum/Scan to the Coordinator

and of ``db::LmDiskannScanState`` (db/LmDiskannScanState.hpp:34-60): a
per-query scan state holding the query vector, k, l_search, and a result
buffer drained across successive Scan() calls.

Counterpart of ``duckdb_lm_diskann_tpu/db/index.py``. The index lives on
``device`` (the card unless the caller asks for the CPU). The reader gate
keeps JAX's rule: a mutation runs with ``donate_buffers`` only while no
reader holds a view; otherwise the port's Coordinator writes copies of the
tables it touches, so a captured view stays point-in-time.
"""

from __future__ import annotations

import shutil
import contextlib
import threading
from pathlib import Path

import numpy as np

from ..common.types import VectorType
from ..core.config import parse_options
from ..core.coordinator import Coordinator
from ..store import checkpoint
from ..store.block_codec import resolve_layout
from ..store.shadow import ShadowStorageService
from . import settings


class LmDiskannScanState:
    """Per-query scan state: result row ids drained chunk-by-chunk
    (LmDiskannScanState.hpp:34-60)."""

    def __init__(self, query: np.ndarray, k: int, l_search: int | None):
        self.query = np.asarray(query, np.float32)
        self.k = int(k)
        self.l_search = l_search
        self.row_ids: np.ndarray | None = None  # filled on first Scan
        self.distances: np.ndarray | None = None
        self.offset = 0
        # Filtered-search pushdown: restrict results to these row ids.
        self.allowed_rowids: np.ndarray | None = None

    @property
    def exhausted(self) -> bool:
        return self.row_ids is not None and self.offset >= len(self.row_ids)


class LmDiskannIndex:
    """Bound vector index over one table column."""

    def __init__(
        self,
        name: str,
        column_dtype,
        dimensions: int,
        options: dict | None = None,
        db_path: str | None = None,
        persist: bool = True,
        session: "settings.Settings | None" = None,
        device="cuda",
    ):
        self.name = name
        self.device = device
        # Per-connection options (the Database passes its own Settings;
        # standalone indexes fall back to the process default).
        self.settings = session if session is not None else settings.GLOBAL
        config = parse_options(options)
        # Dimensions/dtype derive from the column type, never from options
        # (db/LmDiskannIndex.cpp:137-154).
        config.dimensions = int(dimensions)
        config.node_vector_type = VectorType.from_dtype(column_dtype)
        if config.node_vector_type is VectorType.UNKNOWN:
            raise TypeError(
                "LM_DISKANN index requires ARRAY(FLOAT, N) or "
                "ARRAY(TINYINT, N) column (float32/int8 dtype)"
            )
        config.validate()
        self.config = config
        self.layout = resolve_layout(config)  # block size parity check

        # Per-index directory <db>.lmd_idx/<index>/ (:165-235).
        self.directory: Path | None = None
        self.persist = persist
        if db_path is not None:
            self.directory = Path(f"{db_path}.lmd_idx") / name
            self.directory.mkdir(parents=True, exist_ok=True)

        if self.directory is not None and (
            self.directory / "diskann_store.db"
        ).exists():
            try:
                self.coordinator = checkpoint.load_index(
                    self.directory, device=device
                )
                # The persisted config is authoritative: r / metric /
                # edge_type / dims fix the block layout and the array
                # shapes, so reopening with different explicit options must
                # raise rather than silently serialize a mismatched layout
                # (the reference re-derives config from the persisted
                # metadata block, core/StorageManager.cpp:104-117).
                self._check_reopen_options(config, self.coordinator.config)
                persisted = self.coordinator.config
                # Runtime knobs may be overridden per session.
                for knob in ("l_search", "l_insert", "alpha"):
                    if knob in config.explicit_keys:
                        setattr(persisted, knob, getattr(config, knob))
                persisted.validate()
                self.config = persisted
                self.coordinator.params = type(
                    self.coordinator.params
                ).from_config(persisted)
                self.layout = resolve_layout(persisted)
            except FileNotFoundError:
                self.coordinator = Coordinator(config, device=device)
        else:
            self.coordinator = Coordinator(config, device=device)
        if self.directory is not None:
            self.coordinator.shadow_service = ShadowStorageService(self.directory)
        # Locking, upgraded past the reference's shared/exclusive
        # StorageLock (hnsw_index.cpp:191,301-303,415-431):
        #   _lock  — exclusive among WRITERS (DML/vacuum/persist/drop), the
        #            IndexLock analog. Readers do NOT take it.
        #   _state_lock — a tiny mutex guarding the (arrays handle, rowid
        #            table, reader count) triple. Readers hold it only for
        #            the microseconds of capturing a ReadView; writers hold
        #            it across their host-side mutation call so the
        #            view-capture is atomic vs the handle swap.
        # Readers run the actual device search OUTSIDE both locks on their
        # captured view (lock-free reads). Mutations write the tensors in
        # place, so writers "donate" only when _active_readers == 0 and
        # otherwise write copies of the tables they touch
        # (Coordinator.donate_buffers).
        self._lock = threading.RLock()
        self._state_lock = threading.Lock()
        self._active_readers = 0

    @staticmethod
    def _check_reopen_options(parsed, persisted) -> None:
        """Raise if explicitly-passed WITH options conflict with the
        persisted, layout-determining config (r/metric/edge_type/dims)."""
        checks = {
            "metric": ("metric_type", persisted.metric_type),
            "r": ("r", persisted.r),
            "edge_type": ("edge_type", persisted.resolve_edge_type()),
        }
        for key, (attr, have) in checks.items():
            if key not in parsed.explicit_keys:
                continue
            want = getattr(parsed, attr)
            if key == "edge_type":
                want = parsed.resolve_edge_type()
            if want != have:
                raise ValueError(
                    f"LM_DISKANN option {key}={want} conflicts with the "
                    f"persisted index ({key}={have}); drop the index to "
                    "change layout parameters"
                )
        if parsed.dimensions != persisted.dimensions or (
            parsed.node_vector_type != persisted.node_vector_type
        ):
            raise ValueError(
                "column type/dimensions do not match the persisted index "
                f"({persisted.node_vector_type.value}[{persisted.dimensions}])"
            )

    # --- DML forwarding (BoundIndex hooks) ---

    def _write(self, fn):
        """Run one mutation with the reader-gated donation policy: donate
        buffers only when no ReadView can be live (see __init__ locking
        notes). Held for the HOST portion of the mutation only — device
        work is async, so readers stall at most for dispatch time."""
        with self._lock:
            with self._state_lock:
                self.coordinator.donate_buffers = self._active_readers == 0
                try:
                    return fn()
                finally:
                    self.coordinator.donate_buffers = True

    def _maybe_checkpoint_backlog(self) -> None:
        """Bound the crash-replay backlog: checkpoint inline once the
        un-merged delta log exceeds lm_diskann_checkpoint_pending_deltas
        (recovery replays the log at the engine's bulk-insert rate, so the
        bound converts directly into a recovery-time bound —
        docs/DURABILITY.md)."""
        limit = self.settings.get_option("lm_diskann_checkpoint_pending_deltas")
        if (
            not limit
            or self.directory is None
            or self.coordinator.shadow_service is None
        ):
            return
        if self.coordinator.shadow_service.pending_count() >= limit:
            self.persist_to_disk()

    def append(self, rowids, vectors) -> None:
        """Append a chunk (LmDiskannIndex::Append, :350-376 — the reference
        loops row-by-row over Insert; here a batch goes down in one call)."""
        self._write(lambda: self.coordinator.insert(rowids, vectors))
        self._maybe_checkpoint_backlog()

    def insert(self, rowids, vectors) -> None:
        self._write(lambda: self.coordinator.insert(rowids, vectors))
        self._maybe_checkpoint_backlog()

    def delete(self, rowids) -> int:
        n = self._write(lambda: self.coordinator.delete(rowids))
        self._maybe_checkpoint_backlog()
        return n

    def vacuum(self) -> int:
        return self._write(lambda: self.coordinator.vacuum())

    def commit_drop(self) -> None:
        """CommitDrop (:508-514 / Coordinator.cpp:319-351): drop all state
        and remove the index directory."""
        with self._lock:
            self._dropped = True  # persist_to_disk must not resurrect the
            # directory if the auto-checkpoint daemon races a drop
            self.coordinator.handle_commit_drop()
            if self.directory is not None and self.directory.exists():
                shutil.rmtree(self.directory)

    # --- scan surface (InitializeScan/Scan, :639-724) ---

    def initialize_scan(
        self,
        query: np.ndarray,
        k: int,
        l_search: int | None = None,
        allowed_rowids: np.ndarray | None = None,
    ) -> LmDiskannScanState:
        query = np.asarray(query, np.float32).reshape(-1)
        if query.shape[0] != self.config.dimensions:
            raise ValueError(
                f"query dimension {query.shape[0]} != index dimension "
                f"{self.config.dimensions}"
            )
        state = LmDiskannScanState(query, k, l_search)
        state.allowed_rowids = allowed_rowids
        return state

    def scan(self, state: LmDiskannScanState, max_rows: int = 2048) -> np.ndarray:
        """Drain up to max_rows result row ids (Scan, :677-724)."""
        if state.row_ids is None:
            L = self.settings.effective_l_search(
                self.config.l_search, state.l_search
            )
            with self._reader() as view:
                ids, dists = self.coordinator.search(
                    state.query[None, :],
                    state.k,
                    l_search=L,
                    allowed_rowids=state.allowed_rowids,
                    view=view,
                    adaptive_seeds=int(
                        self.settings.get_option("lm_diskann_adaptive_seeds")
                    ),
                )
            keep = ids[0] >= 0
            state.row_ids = ids[0][keep]
            state.distances = dists[0][keep]
        chunk = state.row_ids[state.offset : state.offset + max_rows]
        state.offset += len(chunk)
        return chunk

    @contextlib.contextmanager
    def _reader(self):
        """Reader gate: capture a consistent ReadView under the state lock,
        then run the search with NO lock held — concurrent readers never
        serialize on each other's device work, and writers can proceed
        (non-donating) while reads are in flight."""
        with self._state_lock:
            self._active_readers += 1
            view = self.coordinator.capture_view()
        try:
            yield view
        finally:
            with self._state_lock:
                self._active_readers -= 1

    def search(self, queries, k: int, l_search: int | None = None):
        """Batched search (the MultiScan analog, hnsw_index.cpp:336-378)."""
        L = self.settings.effective_l_search(self.config.l_search, l_search)
        with self._reader() as view:
            return self.coordinator.search(
                np.atleast_2d(queries), k, l_search=L, view=view,
                adaptive_seeds=int(
                    self.settings.get_option("lm_diskann_adaptive_seeds")
                ),
            )

    def snapshot(self):
        """Read-only point-in-time view of the index — the transaction-
        snapshot visibility of the V2 MVCC design (Consolidated
        Proposal:82-96); see Coordinator.snapshot()."""
        with self._lock, self._state_lock:
            return self.coordinator.snapshot()

    # --- persistence (GetStorageInfo / checkpoint, :516-531) ---

    def persist_to_disk(self) -> dict | None:
        """Checkpoint into the index's directory. Returns the save's
        statistics (store/checkpoint.save_index), or None when persistence
        is switched off or the index was dropped."""
        if self.directory is None:
            raise RuntimeError("in-memory index has no directory")
        if not self.settings.get_option("lm_diskann_enable_persistence"):
            return None
        with self._lock:
            if getattr(self, "_dropped", False):
                return None  # dropped while a daemon tick was pending
            return checkpoint.save_index(self.coordinator, self.directory)

    def get_storage_info(self) -> dict:
        """GetStorageInfo (:516-531) + GetInMemorySize accounting."""
        return {
            "name": self.name,
            "count": self.coordinator.count,
            "capacity": self.coordinator.capacity,
            "in_memory_size": self.coordinator.get_in_memory_size(),
            "block_size": self.layout.block_size,
            "dirty": self.coordinator.dirty,
            "directory": str(self.directory) if self.directory else None,
        }

    def verify_and_to_string(self, only_verify: bool = False) -> str:
        """VerifyAndToString (:576-604): structural verification + dump.
        Full invariant check (maps, degrees, zombie edges, reachability)
        lives in utils/verify.py; raises on violations."""
        from ..utils.verify import verify_graph

        coord = self.coordinator
        report = verify_graph(coord)
        if only_verify:
            return ""
        return (
            f"LmDiskannIndex {self.name}: count={coord.count} "
            f"capacity={coord.capacity} entry_rowid={coord.entry_rowid} "
            f"metric={self.config.metric_type.value} "
            f"edge_type={self.config.resolve_edge_type().value} "
            f"R={self.config.r} mean_degree={report['mean_degree']:.2f} "
            f"zombie_edges={report['zombie_edges']} "
            f"reachable={report.get('reachable_fraction', 1.0):.3f}"
        )
