"""Checkpoint / load orchestration: graph.lmd + shadow store, two-phase merge.

Counterpart of ``duckdb_lm_diskann_tpu/store/checkpoint.py``, writing and
reading the same files: a checkpoint that either package saved opens in the
other with the same tables, maps and entry point.

  - Coordinator::SaveIndex/LoadIndex -> StorageManager::SaveIndexContents/
    LoadIndexContents (Coordinator.cpp:239-317; stubbed in the reference at
    StorageManager.cpp:187-239) — implemented here for real.
  - V2 design (Consolidated Proposal:15-26, :96-107, :188-211): graph.lmd
    fixed-size block file + secondary transactional store; checkpoint is an
    idempotent two-phase merge — (1) write + fsync graph.lmd, (2) atomically
    commit lookup/tombstones/checksums/metadata and clear the delta log. A
    crash between phases re-merges harmlessly.
  - Index metadata fields (entry point, count, config, format version)
    mirror index_config.hpp:195-210 / StorageManager.cpp:104-117.
  - Startup reconciliation + recovery (Proposal:88,94,426-429): pending
    deltas detected at load; ``recover`` replays them from the base table
    via IPrimaryStorageService; checksum mismatch -> mark-broken ->
    ``rebuild_from_primary`` (Proposal:429,440).

Block assignment: block_id == device slot. Neighbor ids are serialized as
*row ids* (host-relocatable, reference format); the loader maps them back to
slots through the persisted ``lmd_lookup`` table. Zombie edges (to rows that
died before the checkpoint) serialize as the empty sentinel — a checkpoint
is also a zombie-edge sweep — and blocks of dead slots serialize zeroed.

Both directions move the graph in chunks of ``chunk_bytes`` of blocks,
several chunks at a time on a pool of host threads: a save slices each
chunk on the device, copies only it to the host and encodes it, and hands
the chunks to the block store's writer thread in order; a load reads,
checks and decodes each chunk into its rows of host tables of high-water
length, then copies each table to the device once.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..common.types import EdgeType, INVALID_ROW_ID, MetricType, VectorType
from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, GraphParams, make_graph_arrays
from ..ops.quantize import i4_packed_from_planar_np, i4_planar_from_packed_np
from .block_codec import decode_blocks, encode_blocks, resolve_layout
from .file_service import open_block_file
from .shadow import ShadowStorageService

_CHUNK_BYTES = 64 << 20
# Host threads that encode (save) or read and decode (load) chunks at once.
_WORKERS = min(8, os.cpu_count() or 1)

# The graph tables each codec persists besides vectors/neighbors/valid.
_EDGE_FIELDS = {
    EdgeType.TERNARY: ("edge_pos", "edge_neg"),
    EdgeType.INT8: ("edge_i8", "edge_scale"),
    EdgeType.INT4: ("edge_i4", "edge_scale"),
    EdgeType.FLOAT32: ("edge_f32",),
    EdgeType.FLOAT16: ("edge_f32",),
    EdgeType.FLOAT1BIT: ("edge_pos",),
    EdgeType.NONE: (),
}


def _in_order(fn, items):
    """``fn`` over ``items`` on a pool of _WORKERS threads, results yielded
    in the items' order, at most 2 x _WORKERS calls in flight (numpy, torch
    and the native store release the interpreter lock in their work)."""
    with ThreadPoolExecutor(_WORKERS) as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * _WORKERS:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class IndexCorruptionError(RuntimeError):
    """Checksum/reconciliation failure: index is marked broken; rebuild from
    the base table (Proposal:429,440)."""


def _config_to_dict(config: LmDiskannConfig) -> dict:
    return {
        "metric": config.metric_type.value,
        "r": config.r,
        "l_insert": config.l_insert,
        "alpha": config.alpha,
        "l_search": config.l_search,
        "dimensions": config.dimensions,
        "node_vector_type": config.node_vector_type.value,
        "edge_type": config.resolve_edge_type().value,
        "max_visits": config.max_visits,
        "insert_max_visits": config.insert_max_visits,
        "insert_beam_width": config.insert_beam_width,
    }


def _config_from_dict(d: dict) -> LmDiskannConfig:
    return LmDiskannConfig(
        metric_type=MetricType.parse(d["metric"]),
        r=int(d["r"]),
        l_insert=int(d["l_insert"]),
        alpha=float(d["alpha"]),
        l_search=int(d["l_search"]),
        dimensions=int(d["dimensions"]),
        node_vector_type=VectorType(d["node_vector_type"]),
        edge_type=EdgeType.parse(d["edge_type"]),
        max_visits=int(d.get("max_visits", 0)),
        insert_max_visits=int(d.get("insert_max_visits", 0)),
        insert_beam_width=int(d.get("insert_beam_width", 1)),
    )


def encode_rows(coord: Coordinator, rows: dict) -> np.ndarray:
    """Node blocks uint8[N, block_size] of N consecutive or scattered slots
    whose host rows ``rows`` holds (``vectors``, ``neighbors`` as slots,
    ``valid`` and the codec's edge fields): neighbor slots serialize as
    row ids through the Coordinator's slot map, and dead slots as zeroed
    blocks."""
    neighbors, valid = rows["neighbors"], rows["valid"]
    nbr_rowids = np.where(
        neighbors >= 0,
        coord._slot_rowids[np.maximum(neighbors, 0)],
        np.int64(INVALID_ROW_ID),
    )
    # valid-masked: blocks of dead slots serialize zeroed.
    nbr_rowids = np.where(valid[:, None], nbr_rowids, np.int64(INVALID_ROW_ID))
    kw = {name: rows[name] for name in _EDGE_FIELDS[coord.params.edge_type]}
    if "edge_i4" in kw:
        # planar words -> the disk block format's byte-interleaved packing
        # (ops/quantize.words_per_i4)
        kw["edge_i4"] = i4_packed_from_planar_np(
            kw["edge_i4"], coord.config.dimensions
        )
    blocks = encode_blocks(coord.config, rows["vectors"], nbr_rowids, **kw)
    blocks[~valid] = 0
    return blocks


def save_index(
    coord: Coordinator,
    directory: str | os.PathLike,
    chunk_bytes: int = _CHUNK_BYTES,
) -> dict:
    """Two-phase checkpoint of a Coordinator into an index directory
    (the per-index directory the reference creates as
    ``<db>.lmd_idx/<index>/``, db/LmDiskannIndex.cpp:165-235).

    Incremental: when the directory already holds a committed checkpoint
    and graph.lmd shut down clean, only rows flagged in
    ``arrays.dirty_rows`` are encoded + written (the V2 dirty-block design,
    Consolidated Proposal:96-107,188-211) via scattered writes; otherwise
    the whole file is rewritten. Crash tolerance: the new CRC of every block
    about to be written is STAGED in the shadow store before phase 1, so a
    crash between phases leaves every block matching either its committed
    (old) or staged (new) checksum — the next load recovers instead of
    reporting corruption, and the clean_shutdown flag forces that next save
    to be a full rewrite.

    Returns {"blocks_written", "incremental", "high_water", "backend"}
    (``backend``: the block file's implementation, "native" or "python").
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    layout = resolve_layout(coord.config)
    shadow = ShadowStorageService(directory)
    bf = open_block_file(directory / "graph.lmd", layout.block_size, create=True)
    try:
        hw = coord.allocator.high_water
        arrays = coord.arrays
        prev_hw = shadow.get_metadata("high_water", None)
        incremental = (
            prev_hw is not None
            and not shadow.get_metadata("broken", False)
            and bf.clean_shutdown
            and bf.num_blocks == prev_hw
            and hw >= prev_hw
        )
        if incremental:
            dirty = arrays.dirty_rows[:hw].cpu().numpy()
            idx = np.nonzero(dirty)[0].astype(np.int64)
        else:
            idx = np.arange(hw, dtype=np.int64)

        fields = _EDGE_FIELDS[coord.params.edge_type]

        def encode_chunk(sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            """Device -> host copy + block encode + CRC for one chunk of slot
            indices: a contiguous range is a slice on the device, a scattered
            one an index_select there; only the chunk reaches the host."""
            lo, hi = int(sel[0]), int(sel[-1]) + 1
            if not incremental and hi - lo == len(sel):

                def pull(a):
                    return a[lo:hi].cpu().numpy()
            else:
                sel_d = torch.as_tensor(sel, device=arrays.device)

                def pull(a):
                    return a[sel_d].cpu().numpy()

            names = ("vectors", "neighbors", "valid") + fields
            blocks = encode_rows(
                coord, {name: pull(getattr(arrays, name)) for name in names}
            )
            return blocks, bf.crc32_rows(blocks)

        # Pipelined two-phase write (the V2 flush-daemon design,
        # Consolidated Proposal:96-107): per chunk — stage its CRCs, then
        # hand the blocks to the store's background writer thread and start
        # pulling/encoding the next chunk while the previous one hits disk.
        # Crash safety is per block: every block on disk matches either its
        # committed (old) or staged (new) CRC at all times, so staging
        # chunk-by-chunk preserves the recovery invariant.
        shadow.clear_staged_checksums()
        bf.mark_dirty(True)
        if not incremental:
            bf.truncate(hw)
        checksums_all: list[np.ndarray] = []
        chunk_rows = max(1, chunk_bytes // layout.block_size)
        chunks = [idx[lo : lo + chunk_rows] for lo in range(0, len(idx), chunk_rows)]
        encoded = _in_order(encode_chunk, chunks)
        try:
            for sel, (blocks, crc) in zip(chunks, encoded):
                checksums_all.append(crc)
                shadow.stage_checksums(sel, crc)
                if incremental:
                    bf.submit_write_at(sel, blocks)
                else:
                    bf.submit_write(int(sel[0]), blocks)
        finally:
            encoded.close()  # a failed write waits for the encoders first
        # Drain the writer BEFORE reading num_blocks: the worker thread
        # mutates the header's block count as scattered writes land, so the
        # read is only well-defined at quiescence.
        bf.flush_wait(bf.submit_sync())
        if incremental and bf.num_blocks < hw:
            bf.truncate(hw)  # slots allocated but never written stay 0
            bf.sync()
        checksums = (
            np.concatenate(checksums_all)
            if checksums_all
            else np.empty(0, np.uint32)
        )

        # Phase 2: transactional shadow commit (clears delta log + staged).
        shadow.commit_checkpoint(
            lookup=dict(coord.allocator.rowid_to_slot),
            tombstones=coord.allocator.pending_deletion,
            checksums=dict(zip(idx.tolist(), checksums.tolist())),
            metadata={
                "format_version": 3,
                "config": _config_to_dict(coord.config),
                "entry_rowid": coord.entry_rowid,
                "count": coord.count,
                "high_water": hw,
                "free_slots": coord.allocator.free_slots,
                "broken": False,
            },
            incremental=incremental,
        )
        bf.mark_dirty(False)
        # Nothing is dirty now. A ReadView may hold these tensors while
        # donate_buffers is False: then the live arrays get a zeroed copy.
        if coord.donate_buffers:
            arrays.dirty_rows.zero_()
        else:
            coord.arrays = arrays._replace(
                dirty_rows=torch.zeros_like(arrays.dirty_rows)
            )
        coord.dirty = False
        return {
            "blocks_written": int(len(idx)),
            "incremental": bool(incremental),
            "high_water": hw,
            "backend": bf.backend,
        }
    finally:
        bf.close()
        shadow.close()


def _crc_array(mapping: dict[int, int], n: int) -> np.ndarray:
    """{block: crc} -> int64[n], -1 where a block has no entry."""
    out = np.full(n, -1, np.int64)
    if mapping:
        keys = np.fromiter(mapping.keys(), np.int64, len(mapping))
        vals = np.fromiter(mapping.values(), np.int64, len(mapping))
        inside = keys < n
        out[keys[inside]] = vals[inside]
    return out


def _rowid_to_slot_map(rowids: np.ndarray, slots: np.ndarray):
    """The function int64 row ids -> int32 slots (-1 for an empty id or a
    row not in the lookup) of a persisted lookup table: a direct table
    when the row ids are dense enough (span <= 4 x rows), else a binary
    search over the sorted ids. An empty lookup (a checkpoint taken after
    every row was deleted) resolves nothing."""
    if not len(rowids):
        return lambda ids: np.full(ids.shape, -1, np.int32)
    lo, hi = int(rowids.min()), int(rowids.max())
    if hi - lo < 4 * len(rowids) + 64:
        table = np.full(hi - lo + 1, -1, np.int32)
        table[rowids - lo] = slots

        def dense(ids):
            pos = ids - lo
            inside = (pos >= 0) & (pos <= hi - lo)
            return np.where(inside, table[np.where(inside, pos, 0)], -1)

        return dense
    order = np.argsort(rowids)
    keys, vals = rowids[order], slots[order].astype(np.int32)

    def sparse(ids):
        pos = np.clip(np.searchsorted(keys, ids), 0, len(keys) - 1)
        return np.where((ids >= 0) & (keys[pos] == ids), vals[pos], -1)

    return sparse


def _load_host_state(
    directory: str | os.PathLike,
    verify_checksums: bool = True,
    chunk_bytes: int = _CHUNK_BYTES,
) -> dict:
    """Read + verify an index directory into HOST (numpy) state: the first
    half of every loader. Returns a dict with the config, allocator state,
    and per-field row data at high_water length (word fields as int32 with
    the u32 bits); :func:`load_index` places it on a device."""
    directory = Path(directory)
    shadow = ShadowStorageService(directory)
    try:
        cfg_dict = shadow.get_metadata("config")
        if cfg_dict is None:
            raise FileNotFoundError(f"no index metadata in {directory}")
        config = _config_from_dict(cfg_dict)
        layout = resolve_layout(config)
        hw = int(shadow.get_metadata("high_water", 0))
        if shadow.get_metadata("broken", False):
            raise IndexCorruptionError(
                f"index at {directory} is marked broken; rebuild from the "
                "base table (rebuild_from_primary)"
            )
        pending = shadow.pending_deltas()
        lookup = shadow.load_lookup()  # rowid -> slot
        tombstones = shadow.load_tombstones()
        free_slots = [int(s) for s in shadow.get_metadata("free_slots", [])]

        rowids = np.fromiter(lookup.keys(), np.int64, len(lookup))
        slots = np.fromiter(lookup.values(), np.int64, len(lookup))
        to_slots = _rowid_to_slot_map(rowids, slots)

        et = config.resolve_edge_type()
        vec_dtype = (
            np.int8
            if config.node_vector_type is VectorType.INT8
            else np.float32
        )
        fields = {
            "vectors": np.zeros((hw, config.dimensions), vec_dtype),
            "neighbors": np.full((hw, config.r), -1, np.int32),
            "valid": np.zeros(hw, bool),
        }
        fields["valid"][slots[slots < hw]] = True
        proto = make_graph_arrays(GraphParams.from_config(config), 0, "cpu")
        for name in _EDGE_FIELDS[et]:
            t = getattr(proto, name)
            fields[name] = np.zeros((hw,) + tuple(t.shape[1:]), t.numpy().dtype)
        if verify_checksums and hw:
            want = _crc_array(shadow.load_checksums(), hw)
            staged = _crc_array(shadow.load_staged_checksums(), hw)

        bf = open_block_file(directory / "graph.lmd", layout.block_size, create=False)

        def read_chunk(lo: int) -> np.ndarray:
            """Read, check and decode blocks [lo, lo + chunk_rows) into their
            rows of ``fields`` (chunks write disjoint rows); returns the
            corrupt blocks, of which nothing is decoded."""
            hi = min(lo + chunk_rows, n_read)
            blocks = bf.read_blocks(lo, hi - lo)
            if verify_checksums:
                # A block is consistent if it matches its committed CRC or a
                # staged (phase-1-written, never-committed) CRC — the two
                # states a crash between checkpoint phases can leave.
                got = bf.crc32_rows(blocks).astype(np.int64)
                w, s = want[lo:hi], staged[lo:hi]
                bad = lo + np.nonzero((w >= 0) & (w != got) & (s != got))[0]
                if len(bad):
                    return bad
            dec = decode_blocks(config, blocks)
            fields["vectors"][lo:hi] = dec["vectors"]
            fields["neighbors"][lo:hi] = to_slots(dec["neighbor_rowids"])
            for name in _EDGE_FIELDS[et]:
                rows = dec[name]
                if name == "edge_i4":
                    rows = i4_planar_from_packed_np(rows, config.dimensions)
                    rows = rows.view(np.int32)
                fields[name][lo:hi] = rows
            return np.empty(0, np.int64)

        try:
            n_read = min(hw, bf.num_blocks)
            chunk_rows = max(1, chunk_bytes // layout.block_size)
            bad = list(_in_order(read_chunk, range(0, n_read, chunk_rows)))
        finally:
            bf.close()
        bad_blocks = np.concatenate(bad) if bad else np.empty(0, np.int64)
        if len(bad_blocks):
            shadow.set_metadata("broken", True)
            raise IndexCorruptionError(
                f"checksum mismatch in blocks {bad_blocks[:8].tolist()} of "
                f"{directory}/graph.lmd; index marked broken"
            )

        return {
            "config": config,
            "hw": hw,
            "lookup": lookup,
            "tombstones": tombstones,
            "free_slots": free_slots,
            "pending": pending,
            "entry_rowid": shadow.get_metadata("entry_rowid", INVALID_ROW_ID),
            "fields": fields,
        }
    finally:
        shadow.close()


def _restore_coordinator_meta(
    coord: Coordinator, st: dict, cap: int, entry_fallback=None
) -> None:
    """Fill allocator / rowid maps / recovery flags from host state. The
    entry point is restored when its row survives; otherwise
    ``entry_fallback``, a callable returning (slot, rowid), re-selects it
    after the allocator state is in place (the loaders pass the
    Coordinator's degree scan, over one table or over row blocks, once the
    tables are placed)."""
    lookup = st["lookup"]
    sr = np.full(cap, INVALID_ROW_ID, np.int64)
    if lookup:
        sr[np.fromiter(lookup.values(), np.int64, len(lookup))] = np.fromiter(
            lookup.keys(), np.int64, len(lookup)
        )
    coord._slot_rowids = sr
    coord.allocator.rowid_to_slot = dict(lookup)
    coord.allocator.slot_to_rowid = {s: r for r, s in lookup.items()}
    coord.allocator.high_water = st["hw"]
    coord.allocator.free_slots = st["free_slots"]
    coord.allocator.pending_deletion = st["tombstones"]
    # A loaded index with any tombstoned/freed slots (or pending deltas
    # to replay) may hold zombie in-edges: searches must keep the
    # validity gather (see Coordinator._ever_tombstoned).
    coord._ever_tombstoned = bool(
        st["tombstones"] or st["free_slots"] or st["pending"]
    )
    coord.dirty = False
    coord.needs_recovery = bool(st["pending"])
    coord.pending_deltas = st["pending"]
    if st["entry_rowid"] in lookup:
        coord.entry_slot = lookup[st["entry_rowid"]]
        coord.entry_rowid = st["entry_rowid"]
    elif lookup and entry_fallback is not None:
        coord.entry_slot, coord.entry_rowid = entry_fallback()


def load_index(
    directory: str | os.PathLike,
    verify_checksums: bool = True,
    device="cuda",
) -> Coordinator:
    """Load an index directory into a Coordinator on ``device`` (the card
    unless the caller asks for the CPU)."""
    st = _load_host_state(directory, verify_checksums)
    hw = st["hw"]
    coord = Coordinator(st["config"], initial_capacity=max(1024, hw), device=device)
    # The Coordinator's fresh tables are zero (neighbors -1) past high
    # water; the loaded rows go in front, one host-to-device copy a table.
    arrays: GraphArrays = coord.arrays
    for name, rows in st["fields"].items():
        if hw:
            getattr(arrays, name)[:hw].copy_(torch.from_numpy(rows))
    _restore_coordinator_meta(
        coord, st, coord.capacity, entry_fallback=coord._select_fallback_entry
    )
    return coord


def recover(index, primary, directory: str | os.PathLike) -> int:
    """Replay un-merged deltas after a crash (startup reconciliation,
    Proposal:426-429). ``primary`` is a PrimaryStorageService for re-reading
    vectors of rows whose blocks never reached graph.lmd. Returns the number
    of deltas replayed; saves a clean checkpoint afterwards.

    ``index`` is a Coordinator or any index-like exposing insert/delete and
    ``save`` or ``persist_to_disk`` (db.LmDiskannIndex) and a
    ``.coordinator``.

    The delta log is replayed in sequence order, but consecutive runs of
    the SAME op are coalesced into one batched insert/delete: distinct-row
    inserts commute within a run (and likewise deletes), so batching
    preserves the log's semantics while replacing O(N) single-row device
    dispatches with O(N / batch) ramped batched ones."""
    coord = getattr(index, "coordinator", index)
    pending = getattr(coord, "pending_deltas", [])
    replayed = 0
    run_op: str | None = None
    run_rows: list[int] = []
    run_set: set[int] = set()

    def flush():
        nonlocal replayed, run_op
        if not run_rows:
            return
        if run_op == "insert":
            vecs = np.atleast_2d(
                np.asarray(primary.get_vectors(run_rows), np.float32)
            )
            index.insert(run_rows, vecs)
        else:
            index.delete(run_rows)
        replayed += len(run_rows)
        run_rows.clear()
        run_set.clear()

    for _seq, op, row_id, _block_id in pending:
        in_run = run_op == op and row_id in run_set
        queued_insert = run_op == "insert" and row_id in run_set
        queued_delete = run_op == "delete" and row_id in run_set
        applied = row_id in coord.allocator.rowid_to_slot
        if op == "insert":
            # Skip rows already applied (idempotent replay) or duplicated
            # within the current run — UNLESS the row's delete is queued in
            # the current un-flushed run: then this is the insert half of a
            # crash-logged update (delete r, insert r) and must re-apply
            # after the deletes flush, or the update's row is lost.
            if in_run or (applied and not queued_delete):
                continue
        else:  # delete: only meaningful if the row exists or is queued
            if in_run or (not applied and not queued_insert):
                continue
        if op != run_op:
            flush()  # applies any queued opposite-op rows first (ordering)
            run_op = op
        run_rows.append(row_id)
        run_set.add(row_id)
    flush()
    coord.needs_recovery = False
    coord.pending_deltas = []
    if index is coord:
        save_index(coord, directory)
    elif hasattr(index, "save"):
        index.save(directory)
    elif hasattr(index, "persist_to_disk"):
        # db.LmDiskannIndex checkpoints into its own directory.
        index.persist_to_disk()
    else:
        raise TypeError(
            f"recover(): {type(index).__name__} exposes neither save() nor "
            "persist_to_disk()"
        )
    return replayed


def rebuild_from_primary(
    config: LmDiskannConfig,
    primary,
    rowids,
    directory: str | os.PathLike,
    device="cuda",
) -> Coordinator:
    """Last-resort recovery: rebuild the whole index from the base table
    (mark-index-broken path, Proposal:429,440), on ``device``."""
    coord = Coordinator(config, device=device)
    vectors = primary.get_vectors(rowids)
    coord.bulk_build(list(rowids), np.asarray(vectors, np.float32))
    save_index(coord, directory)
    return coord
