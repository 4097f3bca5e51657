"""Shadow storage service: the transactional delta log + metadata store.

The port's own copy of ``duckdb_lm_diskann_tpu/store/shadow.py`` (stdlib
``sqlite3`` only; the port imports nothing of the JAX package). The schema
is the JAX package's, so either package reads the other's
``diskann_store.db``.

Implements the reference's store::IShadowStorageService interface
(store/IShadowStorageService.hpp:18-46 — LogInsert/LogDelete plus the
commented future commit/rollback/load-state surface; no concrete impl
exists in the reference) following the V2 design's secondary database
``diskann_store.duckdb`` with tables ``__lmd_blocks`` (dirty-block delta),
``lmd_lookup`` (rowid map), ``index_metadata``, ``tombstoned_nodes``
(Consolidated Proposal:15-26, :57-80).

libSQL's production implementation stores everything in SQLite shadow tables
(vectordiskann.c:562-595); we use the stdlib ``sqlite3`` for the same
WAL-backed transactional properties. The big block payloads do NOT live
here — they go to graph.lmd via the native block store; the shadow db holds
the small transactional state plus per-block CRC32 checksums
(Proposal:41 plans a per-block checksum field).
"""

from __future__ import annotations

import json
import os
import sqlite3
from pathlib import Path

import numpy as np

_SCHEMA = """
CREATE TABLE IF NOT EXISTS index_metadata (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS lmd_lookup (
    row_id INTEGER PRIMARY KEY,
    block_id INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS __lmd_blocks (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    op TEXT NOT NULL,          -- 'insert' | 'delete'
    row_id INTEGER NOT NULL,
    block_id INTEGER
);
CREATE TABLE IF NOT EXISTS tombstoned_nodes (
    block_id INTEGER PRIMARY KEY
);
CREATE TABLE IF NOT EXISTS block_checksums (
    block_id INTEGER PRIMARY KEY,
    crc32 INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS staged_checksums (
    block_id INTEGER PRIMARY KEY,
    crc32 INTEGER NOT NULL
);
"""


class ShadowStorageService:
    """SQLite-backed shadow store for one index directory."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.db_path = self.directory / "diskann_store.db"
        self._conn = sqlite3.connect(self.db_path)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    # --- delta log (IShadowStorageService::LogInsert/LogDelete) ---

    def log_insert_batch(self, rowids, block_ids) -> None:
        self._conn.executemany(
            "INSERT INTO __lmd_blocks (op, row_id, block_id) VALUES ('insert', ?, ?)",
            [(int(r), int(b)) for r, b in zip(rowids, block_ids)],
        )
        self._conn.commit()

    def log_delete_batch(self, rowids) -> None:
        self._conn.executemany(
            "INSERT INTO __lmd_blocks (op, row_id, block_id) VALUES ('delete', ?, NULL)",
            [(int(r),) for r in rowids],
        )
        self._conn.commit()

    def pending_deltas(self) -> list[tuple[int, str, int, int | None]]:
        """Un-merged delta entries (seq, op, row_id, block_id) — what would
        replay after a crash before a checkpoint merge."""
        cur = self._conn.execute(
            "SELECT seq, op, row_id, block_id FROM __lmd_blocks ORDER BY seq"
        )
        return cur.fetchall()

    def pending_count(self) -> int:
        """Number of un-merged delta entries — the crash-replay backlog.
        One indexed COUNT(*), cheap enough to poll after every DML batch
        (the auto-checkpoint trigger in db/index.py does)."""
        cur = self._conn.execute("SELECT COUNT(*) FROM __lmd_blocks")
        return int(cur.fetchone()[0])

    # --- metadata (index_metadata block fields, index_config.hpp:195-210,
    #     StorageManager.cpp:104-117) ---

    def set_metadata(self, key: str, value) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO index_metadata (key, value) VALUES (?, ?)",
            (key, json.dumps(value)),
        )
        self._conn.commit()

    def get_metadata(self, key: str, default=None):
        cur = self._conn.execute(
            "SELECT value FROM index_metadata WHERE key = ?", (key,)
        )
        row = cur.fetchone()
        return default if row is None else json.loads(row[0])

    # --- checkpoint merge (two-phase, idempotent: Proposal:190-209) ---

    def clear_staged_checksums(self) -> None:
        with self._conn as c:
            c.execute("DELETE FROM staged_checksums")

    def stage_checksums(self, block_ids, crcs) -> None:
        """Phase 0 of a checkpoint: record the intended new CRC of every
        block about to be (re)written, BEFORE touching graph.lmd. Until the
        commit promotes them, a block is consistent if it matches EITHER its
        committed or its staged checksum — which is exactly the two states
        a crash between phases can leave it in."""
        with self._conn as c:
            c.executemany(
                "INSERT OR REPLACE INTO staged_checksums (block_id, crc32) "
                "VALUES (?, ?)",
                [(int(b), int(v)) for b, v in zip(block_ids, crcs)],
            )

    def load_staged_checksums(self) -> dict[int, int]:
        cur = self._conn.execute(
            "SELECT block_id, crc32 FROM staged_checksums"
        )
        return {int(b): int(v) for b, v in cur.fetchall()}

    def commit_checkpoint(
        self,
        lookup: dict[int, int],
        tombstones,
        checksums: "np.ndarray | dict | None",
        metadata: dict,
        incremental: bool = False,
    ) -> None:
        """Phase 2 of the checkpoint: after graph.lmd has been written and
        fsynced (phase 1), atomically replace the lookup table, tombstones,
        checksums, and metadata, and clear the delta log + staged
        checksums. A crash between the phases re-merges harmlessly on next
        checkpoint (the delta log is still intact; blocks match committed
        or staged CRCs). ``incremental``: upsert ``checksums`` (a
        {block_id: crc} dict) into the committed table instead of replacing
        it wholesale."""
        c = self._conn
        with c:  # single transaction
            c.execute("DELETE FROM lmd_lookup")
            c.executemany(
                "INSERT INTO lmd_lookup (row_id, block_id) VALUES (?, ?)",
                [(int(r), int(b)) for r, b in lookup.items()],
            )
            c.execute("DELETE FROM tombstoned_nodes")
            c.executemany(
                "INSERT INTO tombstoned_nodes (block_id) VALUES (?)",
                [(int(b),) for b in tombstones],
            )
            if incremental:
                if checksums:
                    c.executemany(
                        "INSERT OR REPLACE INTO block_checksums "
                        "(block_id, crc32) VALUES (?, ?)",
                        [(int(b), int(v)) for b, v in dict(checksums).items()],
                    )
            else:
                c.execute("DELETE FROM block_checksums")
                if checksums is not None:
                    items = (
                        dict(checksums).items()
                        if isinstance(checksums, dict)
                        else enumerate(checksums)
                    )
                    c.executemany(
                        "INSERT INTO block_checksums (block_id, crc32) "
                        "VALUES (?, ?)",
                        [(int(i), int(v)) for i, v in items],
                    )
            c.execute("DELETE FROM staged_checksums")
            for k, v in metadata.items():
                c.execute(
                    "INSERT OR REPLACE INTO index_metadata (key, value) "
                    "VALUES (?, ?)",
                    (k, json.dumps(v)),
                )
            merge_seq = (self.get_metadata("merge_sequence_number", 0) or 0) + 1
            c.execute(
                "INSERT OR REPLACE INTO index_metadata (key, value) "
                "VALUES ('merge_sequence_number', ?)",
                (json.dumps(merge_seq),),
            )
            c.execute("DELETE FROM __lmd_blocks")

    def load_lookup(self) -> dict[int, int]:
        cur = self._conn.execute("SELECT row_id, block_id FROM lmd_lookup")
        return {int(r): int(b) for r, b in cur.fetchall()}

    def load_tombstones(self) -> list[int]:
        cur = self._conn.execute("SELECT block_id FROM tombstoned_nodes")
        return [int(b) for (b,) in cur.fetchall()]

    def load_checksums(self) -> dict[int, int]:
        cur = self._conn.execute("SELECT block_id, crc32 FROM block_checksums")
        return {int(b): int(v) for b, v in cur.fetchall()}

    def reset(self) -> None:
        """Drop all persisted state (CREATE INDEX over a stale directory /
        HandleCommitDrop): clears lookup, deltas, tombstones, checksums, and
        metadata in one transaction."""
        c = self._conn
        with c:
            for table in (
                "lmd_lookup",
                "__lmd_blocks",
                "tombstoned_nodes",
                "block_checksums",
                "staged_checksums",
                "index_metadata",
            ):
                c.execute(f"DELETE FROM {table}")

    def close(self) -> None:
        self._conn.close()


class PrimaryStorageService:
    """Fetch base-table vectors by row id, for build/repair.

    Implements store::IPrimaryStorageService (IPrimaryStorageService.hpp:17-55,
    no concrete impl in the reference): the 'base table' here is any mapping
    rowid -> vector — an in-memory array, a memory-mapped file, or a user
    callback — used by mark-broken + rebuild-from-base-table recovery
    (Proposal:429,440).
    """

    def __init__(self, getter):
        """getter: callable (rowids: list[int]) -> np.ndarray [n, D]."""
        self._getter = getter

    @classmethod
    def from_array(cls, rowids, vectors: np.ndarray) -> "PrimaryStorageService":
        index = {int(r): i for i, r in enumerate(rowids)}
        vectors = np.asarray(vectors)

        def getter(ids):
            return vectors[[index[int(r)] for r in ids]]

        return cls(getter)

    def get_vectors(self, rowids) -> np.ndarray:
        return self._getter(list(rowids))

    def get_vector(self, rowid: int) -> np.ndarray:
        return self.get_vectors([rowid])[0]
