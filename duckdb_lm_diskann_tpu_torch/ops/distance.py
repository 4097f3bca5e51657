"""Batched exact-distance functions (L2 / IP / COSINE) on torch tensors.

Counterpart of ``duckdb_lm_diskann_tpu/ops/distance.py``, same semantics
(ComputeExactDistanceFloat, distance.hpp:50-105):

    L2     -> sqrt(max(sum((a-b)^2), 0))
    IP     -> -dot(a, b)
    COSINE -> 1 - clamp(dot / (|a||b|), -1, 1); zero-norm vectors -> 1.0

``pairwise_distance`` keeps the direct-difference form (no cancellation);
the all-pairs forms are one matrix product plus rank-1 norm corrections,
left to ``torch.matmul`` as the JAX package leaves them to XLA. Callers on
the card keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default) so the products stay full float32.
"""

from __future__ import annotations

import torch

from ..common.types import MetricType


def _l2_from_sq(dist_sq: torch.Tensor) -> torch.Tensor:
    # Clamp at zero before the sqrt (distance.hpp:63-66).
    return torch.sqrt(torch.clamp_min(dist_sq, 0.0))


def _cosine(dot, a_sq, b_sq):
    norm = torch.sqrt(a_sq) * torch.sqrt(b_sq)
    safe = torch.where(norm > 0.0, norm, torch.ones_like(norm))
    cos = torch.clamp(dot / safe, -1.0, 1.0)
    zero = (a_sq <= 0.0) | (b_sq <= 0.0)
    return torch.where(zero, torch.ones_like(cos), 1.0 - cos)


def pairwise_distance(
    a: torch.Tensor, b: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """Distance between broadcast-compatible batches: a [..., D], b [..., D]
    -> [...], elementwise over the leading dims."""
    a = a.float()
    b = b.float()
    if metric is MetricType.L2:
        diff = a - b
        return _l2_from_sq((diff * diff).sum(-1))
    if metric is MetricType.IP:
        return -(a * b).sum(-1)
    if metric is MetricType.COSINE:
        return _cosine((a * b).sum(-1), (a * a).sum(-1), (b * b).sum(-1))
    raise ValueError(f"Unsupported metric type {metric}")


def all_pairs_distance(
    queries: torch.Tensor, base: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """queries [B, D] x base [N, D] -> [B, N] through one matrix product."""
    q = queries.float()
    b = base.float()
    dot = q @ b.T
    if metric is MetricType.IP:
        return -dot
    q_sq = (q * q).sum(-1, keepdim=True)  # [B, 1]
    b_sq = (b * b).sum(-1)[None, :]  # [1, N]
    if metric is MetricType.L2:
        return _l2_from_sq(q_sq + b_sq - 2.0 * dot)
    if metric is MetricType.COSINE:
        return _cosine(dot, q_sq, b_sq)
    raise ValueError(f"Unsupported metric type {metric}")


def batched_all_pairs_distance(
    vecs: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """Per-batch candidate-vs-candidate matrix: vecs [T, C, D] -> [T, C, C]
    (RobustPrune's O(R^2) scalar loop as one batched product)."""
    v = vecs.float()
    dot = torch.bmm(v, v.transpose(1, 2))
    if metric is MetricType.IP:
        return -dot
    sq = (v * v).sum(-1)  # [T, C]
    if metric is MetricType.L2:
        return _l2_from_sq(sq[:, :, None] + sq[:, None, :] - 2.0 * dot)
    if metric is MetricType.COSINE:
        return _cosine(dot, sq[:, :, None], sq[:, None, :])
    raise ValueError(f"Unsupported metric type {metric}")


def query_to_neighbors_distance(
    query: torch.Tensor, neighbor_vecs: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """query [B, D] x per-query neighbor vectors [B, R, D] -> [B, R]: each
    query scored against the R cached vectors of its own gathered node row
    (the per-edge distance loop of libsql/vectordiskann.c:1370-1396)."""
    return pairwise_distance(query[:, None, :], neighbor_vecs, metric)


def similarity_to_distance(
    sim: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """CalculateApproxDistance's similarity->distance mapping
    (distance.hpp:231-242) for ternary scores: IP -> -sim, COSINE -> 1-sim
    on the raw integer dot (not a normalised cosine), L2 -> rejected."""
    if metric is MetricType.IP:
        return -sim
    if metric is MetricType.COSINE:
        return 1.0 - sim
    raise ValueError(
        "L2 metric is not directly compatible with ternary approximate "
        "distance. Ternary approximation is for IP/Cosine-like similarities."
    )
