"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy; it imports nothing of the program and takes only
the raw rows and queries the benchmark made. Distances follow the SQL
functions' definitions (``array_distance``, ``array_cosine_distance``,
``array_negative_inner_product``):

    l2      sqrt(sum((q - x)^2))
    cosine  1 - clamp(q.x / (|q| |x|), -1, 1); 1 where a norm is zero
    ip      -q.x

``exact_topk`` is a brute force in blocks on the given device: candidates
ranked by one float32 product (TF32 off) per block, the best ``k + extra``
of them recomputed in float64 and sorted by (distance, row id).
``pair_distances`` recomputes chosen (query, row) pairs in float64.

``control_topk`` is the same brute force in the nearest lower precision,
TF32: both factors of the product rounded to TF32's 10-bit mantissa
(round to nearest, as the tensor cores' conversion does), products summed
in float32, norms in float32. It is the control that the comparison must
find not correct.
"""

from __future__ import annotations

import numpy as np
import torch

QUERY_BLOCK = 1024
BLOCK_BYTES = 1 << 30  # one [queries, rows] score block


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _exact64(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Float64 distance of broadcast pairs q [..., D], x [..., D]."""
    q = q.double()
    x = x.double()
    if metric == "l2":
        return ((q - x) ** 2).sum(-1).sqrt()
    dot = (q * x).sum(-1)
    if metric == "ip":
        return -dot
    if metric == "cosine":
        norm = (q * q).sum(-1).sqrt() * (x * x).sum(-1).sqrt()
        cos = (dot / torch.where(norm > 0, norm, 1.0)).clamp(-1.0, 1.0)
        return torch.where(norm > 0, 1.0 - cos, 1.0)
    raise ValueError(f"unknown metric {metric}")


def pair_distances(rows, queries, q_idx, ids, metric, device) -> np.ndarray:
    """f64 distance of queries[q_idx[i]] to rows[ids[i]] for every i.
    ``rows`` may already be a tensor on ``device``."""
    rows_t = torch.as_tensor(rows, device=device)
    q_t = torch.as_tensor(queries, device=device)
    q_idx = torch.as_tensor(np.asarray(q_idx, np.int64), device=device)
    ids = torch.as_tensor(np.asarray(ids, np.int64), device=device)
    step = max(1, (BLOCK_BYTES // 4) // (rows_t.shape[1] * 8))
    out = []
    for a in range(0, len(ids), step):
        out.append(_exact64(
            q_t[q_idx[a:a + step]], rows_t[ids[a:a + step]], metric
        ).cpu())
    if not out:
        return np.zeros(0, np.float64)
    return torch.cat(out).numpy()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, round half away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _scores(q, x, metric, rounded):
    """[Bq, Bx] float32 distances (or a monotone stand-in for ranking)."""
    dot = (tf32(q) @ tf32(x).T) if rounded else q @ x.T
    if metric == "ip":
        return -dot
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)[None, :]
    if metric == "l2":
        return (qn + xn - 2.0 * dot).clamp_min(0.0).sqrt()
    if metric == "cosine":
        norm = qn.sqrt() * xn.sqrt()
        cos = (dot / torch.where(norm > 0, norm, 1.0)).clamp(-1.0, 1.0)
        return torch.where(norm > 0, 1.0 - cos, 1.0)
    raise ValueError(f"unknown metric {metric}")


def _brute(rows, queries, k, metric, device, rounded, extra):
    no_tf32()
    rows_t = torch.as_tensor(rows, device=device).float()
    n, d = rows_t.shape
    m = min(k + extra, n)
    row_block = max(m, BLOCK_BYTES // (4 * QUERY_BLOCK))
    ids_out, d_out = [], []
    for a in range(0, len(queries), QUERY_BLOCK):
        q = torch.as_tensor(queries[a:a + QUERY_BLOCK], device=device).float()
        best_d = torch.full((len(q), 0), float("inf"), device=device)
        best_i = torch.zeros((len(q), 0), dtype=torch.int64, device=device)
        for b in range(0, n, row_block):
            s = _scores(q, rows_t[b:b + row_block], metric, rounded)
            top = torch.topk(s, min(m, s.shape[1]), dim=1, largest=False)
            cand_d = torch.cat([best_d, top.values], 1)
            cand_i = torch.cat([best_i, top.indices + b], 1)
            keep = torch.topk(cand_d, min(m, cand_d.shape[1]), dim=1,
                              largest=False).indices
            best_d = cand_d.gather(1, keep)
            best_i = cand_i.gather(1, keep)
        if not rounded:
            best_d = _exact64(q[:, None, :], rows_t[best_i], metric)
        # Sort by (distance, row id): ids break ties.
        order = np.lexsort((best_i.cpu().numpy(), best_d.cpu().numpy()),
                           axis=1)
        order = torch.as_tensor(order[:, :k], device=device)
        ids_out.append(best_i.gather(1, order).cpu().numpy())
        d_out.append(best_d.gather(1, order).double().cpu().numpy())
    return np.concatenate(ids_out), np.concatenate(d_out)


def exact_topk(rows, queries, k, metric, device, extra=16):
    """(ids i64[Q, k], f64 distances [Q, k]): the exact top-k of every
    query over all ``rows`` (row id = row index)."""
    return _brute(rows, queries, k, metric, device, False, extra)


def control_topk(rows, queries, k, metric, device):
    """(ids, TF32 distances): the brute force computed in TF32."""
    return _brute(rows, queries, k, metric, device, True, 0)
