"""TERNARY frontier scoring: the hand-written Hopper kernel and its plain
form.

``ternary_frontier_scores`` returns i32[B, R], the ternary dot of each
query's planes with the R cached neighbor planes of its current node. It is
the port of the TPU kernels ``ternary_frontier_scores`` and
``ternary_frontier_scores_deep`` in
``duckdb_lm_diskann_tpu/experiments/pallas_kernels.py``; the CUDA source is
``csrc/ternary_frontier.cu``. As there, the similarity -> distance mapping
stays outside the kernel (``ops.distance.similarity_to_distance``).

Scores are integers: the kernel and the plain version agree exactly.

Dispatch follows the tensors, never a switch: CPU tensors take the plain
PyTorch version (gather, ``ternary_dot``); CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.ternary import ternary_dot
from ._build import KernelLibrary, check_tensors, launch

LIBRARY = KernelLibrary(
    "ternary_frontier", "lmd_ternary_frontier_scores",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
_MAX_SMEM_BYTES = 48 * 1024  # the two query planes staged in shared memory

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
LAUNCHES = 0


def ternary_frontier_scores_plain(
    cur: torch.Tensor,
    q_pos: torch.Tensor,
    q_neg: torch.Tensor,
    edge_pos: torch.Tensor,
    edge_neg: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: gather the rows, popcount-dot them."""
    idx = cur.long()
    return ternary_dot(
        q_pos[:, None, :], q_neg[:, None, :], edge_pos[idx], edge_neg[idx]
    )


def _check(cur, q_pos, q_neg, edge_pos, edge_neg) -> torch.device:
    dev = check_tensors([
        ("cur", cur, torch.int32, 1),
        ("q_pos", q_pos, torch.int32, 2),
        ("q_neg", q_neg, torch.int32, 2),
        ("edge_pos", edge_pos, torch.int32, 3),
        ("edge_neg", edge_neg, torch.int32, 3),
    ])
    B, W = q_pos.shape
    C, R, EW = edge_pos.shape
    if cur.shape[0] != B:
        raise ValueError(f"cur has {cur.shape[0]} rows, queries {B}")
    if tuple(q_neg.shape) != (B, W):
        raise ValueError(f"q_neg shape {tuple(q_neg.shape)} != {(B, W)}")
    if EW != W or tuple(edge_neg.shape) != (C, R, W):
        raise ValueError(
            f"edge planes {tuple(edge_pos.shape)} / {tuple(edge_neg.shape)} "
            f"do not match {W} query words"
        )
    if 2 * W * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"{W} words per plane exceed the staged query limit")
    if C == 0 and B > 0:
        raise ValueError("edge plane table is empty")
    return dev


def ternary_frontier_scores(
    cur: torch.Tensor,  # i32[B] current node slot per query
    q_pos: torch.Tensor,  # i32[B, W] query planes (u32 bits)
    q_neg: torch.Tensor,  # i32[B, W]
    edge_pos: torch.Tensor,  # i32[C, R, W]
    edge_neg: torch.Tensor,  # i32[C, R, W]
) -> torch.Tensor:
    """i32[B, R] ternary scores of every cached neighbor of each query's
    current node. CPU tensors: the plain version. CUDA tensors: the kernel,
    or an exception."""
    global LAUNCHES
    if _check(cur, q_pos, q_neg, edge_pos, edge_neg).type == "cpu":
        return ternary_frontier_scores_plain(
            cur, q_pos, q_neg, edge_pos, edge_neg
        )
    B, W = q_pos.shape
    C, R, _ = edge_pos.shape
    out = torch.empty((B, R), dtype=torch.int32, device=cur.device)
    launch(LIBRARY, (cur, q_pos, q_neg, edge_pos, edge_neg, out), (B, C, R, W))
    LAUNCHES += 1
    return out
