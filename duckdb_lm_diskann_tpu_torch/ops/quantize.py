"""INT8 and INT4 edge-cache codes.

Counterpart of ``duckdb_lm_diskann_tpu/ops/quantize.py``.

INT8: per-vector abs-max codes, scale = max|v| / 127 (a division, as the
source says), code = clip(round(v / scale), -127, 127); an all-zero vector
gets scale 0 and zero codes.

INT4: a code vector is ceil(D/8) 32-bit words; nibble slot s of word w
holds dim s*DW + w (DW = ceil(D/8)), as two's-complement 4-bit values in
[-7, 7] with a per-vector scale max|v|/7. Pad nibbles (dims >= D) are zero.

The words are stored as int32 with the same bits as the JAX package's
uint32 words: torch on the CPU has no right shift for uint32. An arithmetic
shift followed by ``& 0xF`` extracts the same nibble either way.

The numpy helpers are copies of the JAX module's (that module imports jax):
the packed byte-interleaved host/disk format and its converters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def half_dims(d: int) -> int:
    """Packed byte count of an INT4 code vector (host/disk format)."""
    return (d + 1) // 2


def words_per_i4(d: int) -> int:
    """32-bit words per INT4 code vector in the planar device layout."""
    return (d + 7) // 8


def encode_int8(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """vectors [..., D] -> (codes int8 [..., D], scales f32 [...])."""
    v = vectors.float()
    scale = v.abs().amax(-1) / 127.0
    pos = scale > 0.0
    inv = torch.where(
        pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
        torch.zeros_like(scale),
    )
    codes = torch.clamp(torch.round(v * inv[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def decode_int8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes int8 [..., D], scales [...] -> f32 [..., D]."""
    return codes.float() * scales[..., None]


def encode_int8_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HOST form of ``encode_int8``."""
    v = np.asarray(vectors, dtype=np.float32)
    scale = np.max(np.abs(v), axis=-1) / 127.0
    inv = np.where(scale > 0.0, 1.0 / np.where(scale > 0.0, scale, 1.0), 0.0)
    codes = np.clip(np.round(v * inv[..., None]), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def decode_int8_np(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """HOST form of ``decode_int8``."""
    return codes.astype(np.float32) * np.asarray(scales)[..., None]


def encode_int4(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """vectors [..., D] -> (planar words int32 [..., ceil(D/8)], scales f32
    [...]). code = clip(round(v / scale), -7, 7), scale = max|v| / 7."""
    v = vectors.float()
    D = v.shape[-1]
    dw = words_per_i4(D)
    if D != 8 * dw:
        v = F.pad(v, (0, 8 * dw - D))
    scale = v[..., :D].abs().amax(-1) / 7.0
    pos = scale > 0.0
    inv = torch.where(
        pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
        torch.zeros_like(scale),
    )
    q = torch.clamp(torch.round(v * inv[..., None]), -7, 7).to(torch.int32)
    u = (q & 0xF).reshape(*v.shape[:-1], 8, dw)
    words = u[..., 0, :]
    for s in range(1, 8):
        words = words | (u[..., s, :] << (4 * s))
    return words, scale


def unpack_int4(words: torch.Tensor, d: int) -> torch.Tensor:
    """planar words int32 [..., ceil(D/8)] -> signed f32 codes [..., D]."""
    w = words.to(torch.int32)
    parts = [(((w >> (4 * s)) & 0xF) ^ 8) - 8 for s in range(8)]
    return torch.cat(parts, dim=-1)[..., :d].float()


def decode_int4(
    words: torch.Tensor, scales: torch.Tensor, d: int
) -> torch.Tensor:
    return unpack_int4(words, d) * scales[..., None]


def encode_int4_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HOST: vectors -> byte-interleaved u8 codes (dim 2i low nibble, 2i+1
    high nibble) and f32 scales."""
    v = np.asarray(vectors, np.float32)
    if v.shape[-1] % 2:
        v = np.concatenate(
            [v, np.zeros(v.shape[:-1] + (1,), np.float32)], axis=-1
        )
    abs_max = np.max(np.abs(v), axis=-1)
    scale = abs_max / 7.0
    inv = np.where(scale > 0.0, 1.0 / np.where(scale > 0.0, scale, 1.0), 0.0)
    q = np.clip(np.round(v * inv[..., None]), -7, 7).astype(np.int32)
    u = (q & 0xF).astype(np.uint32)
    packed = (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32)


def decode_int4_np(packed: np.ndarray, scales: np.ndarray, d: int) -> np.ndarray:
    """HOST: byte-interleaved u8 codes [..., ceil(D/2)] (dim 2i in the low
    nibble, 2i+1 in the high one) and scales [...] -> f32 [..., D]; the
    nibbles sign-extend as (x ^ 8) - 8 and an odd D drops its pad nibble.
    The packed format, not the planar words: ``i4_packed_from_planar_np``
    turns those into it."""
    u = np.asarray(packed).astype(np.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    out = np.stack([lo, hi], axis=-1).reshape(*u.shape[:-1], -1)
    return out[..., :d].astype(np.float32) * np.asarray(scales)[..., None]


def i4_planar_from_packed_np(packed: np.ndarray, d: int) -> np.ndarray:
    """HOST: byte-interleaved u8 [..., ceil(D/2)] -> planar u32 words
    [..., ceil(D/8)] (the JAX package's words; pad nibbles zero).

    Byte k of a little-endian word w holds nibble slots 2k (low) and 2k+1
    (high), i.e. dims 2k*DW + w and (2k+1)*DW + w, so the words are
    assembled from bytes: 8-bit torch ops on the CPU, no 32-bit shifts."""
    u = torch.from_numpy(np.ascontiguousarray(packed, np.uint8))
    lead, dh = tuple(u.shape[:-1]), u.shape[-1]
    dw = words_per_i4(d)
    nib = torch.zeros(lead + (8 * dw,), dtype=torch.uint8)  # dim s*DW + w
    nib[..., 0 : 2 * dh : 2] = u & 0xF
    nib[..., 1 : 2 * dh : 2] = u >> 4
    nib[..., d:] = 0  # the odd-D pad nibble must not leak into the words
    by_word = nib.reshape(lead + (8, dw)).transpose(-1, -2)  # [..., w, s]
    word_bytes = (by_word[..., 0::2] | (by_word[..., 1::2] << 4)).contiguous()
    return word_bytes.numpy().view("<u4").reshape(lead + (dw,)).astype(np.uint32)


def i4_packed_from_planar_np(words: np.ndarray, d: int) -> np.ndarray:
    """HOST: planar words (u32, or int32 with the same bits) -> packed u8,
    the inverse of i4_planar_from_packed_np (an odd D's pad nibble is
    zero)."""
    w = np.ascontiguousarray(words)
    w = w.view(np.uint32) if w.dtype == np.int32 else w.astype(np.uint32)
    lead, dw = w.shape[:-1], w.shape[-1]
    b = w.astype("<u4", copy=False).view(np.uint8).reshape(lead + (dw, 4))
    b = torch.from_numpy(b)
    by_word = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(lead + (dw, 8))
    nib = by_word.transpose(-1, -2).reshape(lead + (8 * dw,))  # dim s*DW + w
    nib = nib[..., : 2 * half_dims(d)].clone()
    nib[..., d:] = 0
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).numpy()
