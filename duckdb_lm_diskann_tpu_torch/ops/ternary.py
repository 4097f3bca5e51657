"""Ternary quantization: sign bit-plane encoding + popcount dot product.

Counterpart of ``duckdb_lm_diskann_tpu/ops/ternary.py`` (the reference's
``src/lm_diskann/core/ternary_quantization.hpp``).

Encoding (ternary_quantization.hpp:146-199):
    value > 0  -> bit set in the positive plane
    value < 0  -> bit set in the negative plane
    value == 0 -> neither

Dimension d lives at bit (d % 32) of 32-bit word (d / 32), and a plane is
padded to 2*ceil(D/64) words, so that it is the little-endian split of the
reference's u64 words (W = 30 at D = 960). The JAX package stores the words
as uint32; here they are int32 with the same bits, because torch on the CPU
has no uint32 shifts. Bit 31 makes a word negative: the encoder assembles
the bits in int64 and narrows with the same bit pattern.

Ternary dot product (ternary_quantization.hpp:44):
    dot = pop(q+ & v+) - pop(q+ & v-) - pop(q- & v+) + pop(q- & v-)

torch has no popcount: ``popcount32`` is a SWAR count in int64, where every
intermediate stays non-negative and no shift drags a sign bit in. The CUDA
kernel (``kernels/ternary_frontier.py``) uses ``__popc``.

The numpy forms are copies of the JAX module's host helpers (uint32 planes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import words_per_plane_u32

_BIT_WEIGHTS = [1 << j for j in range(32)]


def encode_ternary(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode float vectors [..., D] into (pos, neg) planes [..., W] int32
    (the JAX package's uint32 bits)."""
    d = vectors.shape[-1]
    w = words_per_plane_u32(d)
    v = vectors
    if w * 32 != d:
        v = F.pad(v, (0, w * 32 - d))
    bits = v.reshape(*v.shape[:-1], w, 32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=v.device)

    def plane(mask: torch.Tensor) -> torch.Tensor:
        word = torch.where(mask, weights, 0).sum(-1)  # int64 in [0, 2^32)
        return torch.where(word >= 1 << 31, word - (1 << 32), word).to(
            torch.int32
        )

    return plane(bits > 0), plane(bits < 0)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding u32 bits) ->
    int64 counts."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = (x & 0x55555555) + ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x & 0x0F0F0F0F) + ((x >> 4) & 0x0F0F0F0F)
    x = (x & 0x00FF00FF) + ((x >> 8) & 0x00FF00FF)
    return (x & 0x0000FFFF) + ((x >> 16) & 0x0000FFFF)


def ternary_dot(
    q_pos: torch.Tensor,
    q_neg: torch.Tensor,
    v_pos: torch.Tensor,
    v_neg: torch.Tensor,
) -> torch.Tensor:
    """Ternary dot over the trailing word axis, broadcasting leading dims.
    Returns int32 scores (higher = more similar), the reference's integer."""
    pp = popcount32(q_pos & v_pos)
    pn = popcount32(q_pos & v_neg)
    np_ = popcount32(q_neg & v_pos)
    nn = popcount32(q_neg & v_neg)
    return ((pp - pn) - (np_ - nn)).sum(-1).to(torch.int32)


def ternary_similarity(
    query: torch.Tensor, v_pos: torch.Tensor, v_neg: torch.Tensor
) -> torch.Tensor:
    """ComputeApproxSimilarityTernary (distance.hpp:121-153): encode the
    float query once, then popcount-dot it against stored neighbor planes.

    query: [B, D]; v_pos/v_neg: [B, ..., W] -> similarity [B, ...] f32."""
    q_pos, q_neg = encode_ternary(query)
    extra = v_pos.dim() - q_pos.dim()
    if extra:
        shape = q_pos.shape[:1] + (1,) * extra + q_pos.shape[1:]
        q_pos = q_pos.reshape(shape)
        q_neg = q_neg.reshape(shape)
    return ternary_dot(q_pos, q_neg, v_pos, v_neg).float()


def encode_ternary_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HOST: float vectors [..., D] -> (pos, neg) uint32 planes [..., W]."""
    vectors = np.asarray(vectors, dtype=np.float32)
    d = vectors.shape[-1]
    w = words_per_plane_u32(d)
    pad = w * 32 - d
    if pad:
        pad_widths = [(0, 0)] * (vectors.ndim - 1) + [(0, pad)]
        vectors = np.pad(vectors, pad_widths)
    bits = vectors.reshape(*vectors.shape[:-1], w, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32)).reshape(1, 32)
    pos = ((bits > 0).astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)
    neg = ((bits < 0).astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)
    return pos, neg


def ternary_dot_np(
    q_pos: np.ndarray, q_neg: np.ndarray, v_pos: np.ndarray, v_neg: np.ndarray
) -> np.ndarray:
    """HOST: the ternary dot of uint32 planes -> int64 scores."""

    def pop(x):
        return np.vectorize(lambda v: bin(int(v)).count("1"))(x).astype(np.int64)

    return (
        pop(q_pos & v_pos).sum(-1)
        - pop(q_pos & v_neg).sum(-1)
        - pop(q_neg & v_pos).sum(-1)
        + pop(q_neg & v_neg).sum(-1)
    )
