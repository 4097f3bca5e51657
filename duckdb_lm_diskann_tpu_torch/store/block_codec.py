"""Node-block binary codec: serialize graph rows into the reference's
on-disk node-block format.

The port's own copy of ``duckdb_lm_diskann_tpu/store/block_codec.py`` (the
port imports nothing of the JAX package), byte for byte the same format, so
that checkpoints written by either package open in the other.

Bit-compatible with NodeLayoutOffsets / CalculateLayoutInternal
(core/index_config.cpp:104-148) for TERNARY edge caches (the reference's
implicit layout, format version 3):

    u16 neighbor_count @ 0
    8B-aligned node vector (f32[D] or i8[D])
    row_t-aligned R x i64 neighbor ROW IDS (not slots — the disk format is
    host-relocatable; slots are a device-runtime notion)
    8B-aligned R x positive ternary planes (u64 words, LE)
    8B-aligned R x negative ternary planes
    zero padding to the sector-aligned block size

Empty neighbor slots carry the reference's sentinel: row_t maximum
(GraphManager.cpp:155 uses NumericLimits<row_t>::Maximum()).

For the INT8/INT4/FLOAT32/FLOAT16/FLOAT1BIT edge-cache extensions (which the
reference's format has no slot for — its edge-compression write path is
stubbed, GraphManager.cpp:402-444) the plane areas are repurposed:
    INT8:    R x (i8[D] codes) planes area; R x f32 scales appended after
    INT4:    R x (u8[ceil(D/2)] byte-interleaved codes); R x f32 scales after
    FLOAT32: R x f32[D] vectors (FLOAT16: R x f16[D])
    FLOAT1BIT: R x one sign plane (the positive-plane area)
The metadata record (store/shadow.py) tags the edge_type + a format version
so readers pick the right decoder.

Word fields (ternary / sign planes) are 32-bit words. The port keeps them as
int32 with the JAX package's uint32 bits (core/graph.py): the encoder takes
either dtype and writes the same bytes; the decoder returns int32.

Encoding/decoding is fully vectorized over all N blocks (no per-node Python
loop): the whole graph serializes as a handful of strided numpy writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..common.types import EdgeType, VectorType
from ..core.config import (
    LmDiskannConfig,
    NodeLayout,
    SECTOR_SIZE,
    align_value,
    calculate_layout,
    ternary_plane_size_bytes,
)

# Sentinel the reference writes into empty neighbor-id slots.
ROW_ID_SENTINEL = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class ExtendedLayout:
    """Resolved byte layout for any edge type (TERNARY == reference v3)."""

    base: NodeLayout
    edge_type: EdgeType
    # INT8/INT4 extension: scales live after the (repurposed) code area.
    scales_offset: int
    block_size: int


def resolve_layout(config: LmDiskannConfig) -> ExtendedLayout:
    base = calculate_layout(config)
    et = config.resolve_edge_type()
    d, r = config.dimensions, config.r
    if et is EdgeType.TERNARY or et is EdgeType.NONE:
        return ExtendedLayout(base, et, 0, base.block_size_bytes)
    if et is EdgeType.INT8:
        # codes occupy the pos-planes slot region, resized to R*D i8.
        codes_end = base.neighbor_pos_planes_offset + r * d
        scales_offset = align_value(codes_end, 4)
        total = scales_offset + r * 4
        return ExtendedLayout(base, et, scales_offset, align_value(total, SECTOR_SIZE))
    if et is EdgeType.INT4:
        dh = (d + 1) // 2
        codes_end = base.neighbor_pos_planes_offset + r * dh
        scales_offset = align_value(codes_end, 4)
        total = scales_offset + r * 4
        return ExtendedLayout(base, et, scales_offset, align_value(total, SECTOR_SIZE))
    if et is EdgeType.FLOAT32:
        total = base.neighbor_pos_planes_offset + r * d * 4
        return ExtendedLayout(base, et, 0, align_value(total, SECTOR_SIZE))
    if et is EdgeType.FLOAT16:
        total = base.neighbor_pos_planes_offset + r * d * 2
        return ExtendedLayout(base, et, 0, align_value(total, SECTOR_SIZE))
    if et is EdgeType.FLOAT1BIT:
        # One sign plane per neighbor — exactly the reference's pos-plane
        # region; the neg-plane region is simply absent.
        total = base.neighbor_pos_planes_offset + r * ternary_plane_size_bytes(d)
        return ExtendedLayout(base, et, 0, align_value(total, SECTOR_SIZE))
    raise ValueError(et)


def _word_bytes(arr: np.ndarray, n: int) -> np.ndarray:
    """32-bit words (uint32, or int32 holding the same bits) -> their
    little-endian bytes, one row per node: the bits are reinterpreted,
    never converted."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.int32:
        a = a.astype(np.uint32)
    return a.view(np.uint8).reshape(n, -1)


def encode_blocks(
    config: LmDiskannConfig,
    vectors: np.ndarray,  # [N, D] f32 (or int8 source values as f32)
    neighbor_rowids: np.ndarray,  # [N, R] i64, <0 => empty
    edge_pos: np.ndarray | None = None,  # [N, R, W32] u32 or int32 bits
    edge_neg: np.ndarray | None = None,
    edge_i8: np.ndarray | None = None,  # [N, R, D] i8
    edge_i4: np.ndarray | None = None,  # [N, R, ceil(D/2)] u8 packed
    edge_scale: np.ndarray | None = None,  # [N, R] f32
    edge_f32: np.ndarray | None = None,  # [N, R, D] f32
) -> np.ndarray:
    """Serialize N node rows -> uint8[N, block_size]."""
    lay = resolve_layout(config)
    base = lay.base
    n = vectors.shape[0]
    r, d = config.r, config.dimensions
    out = np.zeros((n, lay.block_size), np.uint8)

    counts = (neighbor_rowids >= 0).sum(axis=1).astype(np.uint16)
    out[:, 0:2] = counts[:, None].view(np.uint8).reshape(n, 2)

    if config.node_vector_type is VectorType.INT8:
        vec_bytes = np.ascontiguousarray(vectors.astype(np.int8)).view(np.uint8)
    else:
        vec_bytes = np.ascontiguousarray(vectors.astype(np.float32)).view(np.uint8)
    vo = base.node_vector_offset
    out[:, vo : vo + vec_bytes.shape[1]] = vec_bytes

    ids = np.where(neighbor_rowids >= 0, neighbor_rowids, ROW_ID_SENTINEL)
    ids_bytes = np.ascontiguousarray(ids.astype(np.int64)).view(np.uint8).reshape(n, -1)
    io = base.neighbor_ids_offset
    out[:, io : io + ids_bytes.shape[1]] = ids_bytes

    et = lay.edge_type
    if et is EdgeType.TERNARY:
        plane = ternary_plane_size_bytes(d)  # per-neighbor bytes (u64 words)
        for arr, off in ((edge_pos, base.neighbor_pos_planes_offset),
                         (edge_neg, base.neighbor_neg_planes_offset)):
            a = _word_bytes(arr, n)[:, : r * plane]
            out[:, off : off + a.shape[1]] = a
    elif et is EdgeType.INT8:
        codes = np.ascontiguousarray(edge_i8.astype(np.int8)).view(np.uint8)
        codes = codes.reshape(n, r * d)
        off = base.neighbor_pos_planes_offset
        out[:, off : off + r * d] = codes
        sc = np.ascontiguousarray(edge_scale.astype(np.float32)).view(np.uint8)
        sc = sc.reshape(n, r * 4)
        out[:, lay.scales_offset : lay.scales_offset + r * 4] = sc
    elif et is EdgeType.INT4:
        dh = (d + 1) // 2
        codes = np.ascontiguousarray(edge_i4.astype(np.uint8)).reshape(n, r * dh)
        off = base.neighbor_pos_planes_offset
        out[:, off : off + r * dh] = codes
        sc = np.ascontiguousarray(edge_scale.astype(np.float32)).view(np.uint8)
        sc = sc.reshape(n, r * 4)
        out[:, lay.scales_offset : lay.scales_offset + r * 4] = sc
    elif et is EdgeType.FLOAT32:
        ev = np.ascontiguousarray(edge_f32.astype(np.float32)).view(np.uint8)
        ev = ev.reshape(n, r * d * 4)
        off = base.neighbor_pos_planes_offset
        out[:, off : off + r * d * 4] = ev
    elif et is EdgeType.FLOAT16:
        ev = np.ascontiguousarray(edge_f32.astype(np.float16)).view(np.uint8)
        ev = ev.reshape(n, r * d * 2)
        off = base.neighbor_pos_planes_offset
        out[:, off : off + r * d * 2] = ev
    elif et is EdgeType.FLOAT1BIT:
        plane = ternary_plane_size_bytes(d)
        a = _word_bytes(edge_pos, n)[:, : r * plane]
        off = base.neighbor_pos_planes_offset
        out[:, off : off + a.shape[1]] = a
    # NONE: nothing cached.
    return out


def decode_blocks(config: LmDiskannConfig, blocks: np.ndarray) -> dict:
    """uint8[N, block_size] -> dict of arrays (inverse of encode_blocks);
    word fields come back as int32 holding the u32 bits."""
    lay = resolve_layout(config)
    base = lay.base
    blocks = np.ascontiguousarray(blocks, np.uint8)
    n = blocks.shape[0]
    r, d = config.r, config.dimensions

    counts = blocks[:, 0:2].copy().view(np.uint16).reshape(n)
    vo = base.node_vector_offset
    if config.node_vector_type is VectorType.INT8:
        vectors = blocks[:, vo : vo + d].copy().view(np.int8).reshape(n, d)
    else:
        vectors = blocks[:, vo : vo + 4 * d].copy().view(np.float32).reshape(n, d)

    io = base.neighbor_ids_offset
    ids = blocks[:, io : io + 8 * r].copy().view(np.int64).reshape(n, r)
    ids = np.where(ids == ROW_ID_SENTINEL, np.int64(-1), ids)

    out = {"counts": counts, "vectors": vectors, "neighbor_rowids": ids}
    et = lay.edge_type
    if et is EdgeType.TERNARY:
        plane = ternary_plane_size_bytes(d)
        w32 = plane // 4
        for name, off in (("edge_pos", base.neighbor_pos_planes_offset),
                          ("edge_neg", base.neighbor_neg_planes_offset)):
            a = blocks[:, off : off + r * plane].copy().view(np.int32)
            out[name] = a.reshape(n, r, w32)
    elif et is EdgeType.INT8:
        off = base.neighbor_pos_planes_offset
        out["edge_i8"] = blocks[:, off : off + r * d].copy().view(np.int8).reshape(n, r, d)
        so = lay.scales_offset
        out["edge_scale"] = blocks[:, so : so + 4 * r].copy().view(np.float32).reshape(n, r)
    elif et is EdgeType.INT4:
        dh = (d + 1) // 2
        off = base.neighbor_pos_planes_offset
        out["edge_i4"] = blocks[:, off : off + r * dh].copy().reshape(n, r, dh)
        so = lay.scales_offset
        out["edge_scale"] = blocks[:, so : so + 4 * r].copy().view(np.float32).reshape(n, r)
    elif et is EdgeType.FLOAT32:
        off = base.neighbor_pos_planes_offset
        out["edge_f32"] = (
            blocks[:, off : off + 4 * r * d].copy().view(np.float32).reshape(n, r, d)
        )
    elif et is EdgeType.FLOAT16:
        off = base.neighbor_pos_planes_offset
        out["edge_f32"] = (
            blocks[:, off : off + 2 * r * d].copy().view(np.float16).reshape(n, r, d)
        )
    elif et is EdgeType.FLOAT1BIT:
        plane = ternary_plane_size_bytes(d)
        w32 = plane // 4
        off = base.neighbor_pos_planes_offset
        out["edge_pos"] = (
            blocks[:, off : off + r * plane].copy().view(np.int32).reshape(n, r, w32)
        )
    return out
