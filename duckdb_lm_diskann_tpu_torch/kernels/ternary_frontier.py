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
raise. The kernel's launch plan (persistent grid, ring stages, bulk or
vector branch) is ``_build.ring_plan`` of this call's sizes and pointers.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.ternary import ternary_dot
from ._build import (
    KernelLibrary,
    RingPlan,
    check_stage_fits,
    check_tensors,
    launch,
    pad16,
    ring_plan,
    sm_count,
)

LIBRARY = KernelLibrary(
    "ternary_frontier", "lmd_ternary_frontier_scores",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)

# The kernel's kBlocksPerSm (csrc/ternary_frontier.cu): the most blocks a SM holds.
BLOCKS_PER_SM = 4

# Kernel launches since the last reset (chip_smoke.py reads and resets it),
# and the plan of the last launch.
LAUNCHES = 0
LAST_PLAN: RingPlan | None = None


def stage_bytes(R: int, W: int) -> int:
    """One query's ring stage (csrc/ternary_frontier.cu, Layout): the two
    plane blocks, then the two query-plane windows."""
    return 2 * pad16(R * W * 4) + 2 * (pad16(W * 4) + 16)


def _launch_plan(cur, q_pos, q_neg, edge_pos, edge_neg) -> RingPlan:
    """The plan a launch on these CUDA tensors takes."""
    _, R, W = edge_pos.shape
    return ring_plan(
        cur.shape[0], sm_count(cur.device), stage_bytes(R, W),
        pointers=[t.data_ptr() for t in (q_pos, q_neg, edge_pos, edge_neg)],
        block_bytes=[R * W * 4], max_blocks_per_sm=BLOCKS_PER_SM,
    )


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
    check_stage_fits(stage_bytes(R, W), f"{R} rows of {W} words")
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
    global LAUNCHES, LAST_PLAN
    if _check(cur, q_pos, q_neg, edge_pos, edge_neg).type == "cpu":
        return ternary_frontier_scores_plain(
            cur, q_pos, q_neg, edge_pos, edge_neg
        )
    B, W = q_pos.shape
    C, R, _ = edge_pos.shape
    out = torch.empty((B, R), dtype=torch.int32, device=cur.device)
    if B == 0:
        return out
    plan = _launch_plan(cur, q_pos, q_neg, edge_pos, edge_neg)
    launch(
        LIBRARY, (cur, q_pos, q_neg, edge_pos, edge_neg, out),
        (B, C, R, W, plan.grid, plan.stages, plan.stage_bytes, int(plan.bulk)),
    )
    LAUNCHES += 1
    LAST_PLAN = plan
    return out
