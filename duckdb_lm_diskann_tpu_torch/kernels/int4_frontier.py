"""INT4 frontier scoring: the hand-written Hopper kernel and its plain form.

``int4_frontier_scores`` returns f32[B, R], the distance from each query to
the R dequantized INT4 neighbor codes cached in its current node's row. It
is the port of the TPU kernels ``int4_frontier_scores`` and
``int4_frontier_scores_deep`` in
``duckdb_lm_diskann_tpu/experiments/pallas_kernels.py``; the CUDA source is
``csrc/int4_frontier.cu``.

Dispatch follows the tensors, never a switch: tensors on the CPU take the
plain PyTorch version (gather, ``decode_int4``, ``pairwise_distance``);
tensors on a CUDA device launch the kernel or raise. The kernel is built
with nvcc at first use (``kernels/_build.py``) and bound with ctypes
through a plain C entry point. The kernel's launch plan (persistent grid,
ring stages, bulk or vector branch) is ``_build.ring_plan`` of this call's
sizes and pointers.
"""

from __future__ import annotations

import ctypes

import torch

from ..common.types import MetricType
from ..ops.distance import pairwise_distance
from ..ops.quantize import decode_int4
from ._build import (
    METRIC_CODE,
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
    "int4_frontier", "lmd_int4_frontier_scores",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)

# The kernel's kBlocksPerSm (csrc/int4_frontier.cu): the most blocks a SM holds.
BLOCKS_PER_SM = 8

# Kernel launches since the last reset (chip_smoke.py reads and resets it),
# and the plan of the last launch.
LAUNCHES = 0
LAST_PLAN: RingPlan | None = None


def stage_bytes(R: int, D: int, DW: int) -> int:
    """One query's ring stage (csrc/int4_frontier.cu, Layout): the code
    block, the scales, then the query-row window."""
    return pad16(R * DW * 4) + pad16(R * 4) + pad16(D * 4) + 16


def _launch_plan(cur, queries, codes, scale) -> RingPlan:
    """The plan a launch on these CUDA tensors takes."""
    D = queries.shape[1]
    _, R, DW = codes.shape
    return ring_plan(
        cur.shape[0], sm_count(cur.device), stage_bytes(R, D, DW),
        pointers=[t.data_ptr() for t in (queries, codes, scale)],
        block_bytes=[R * DW * 4, R * 4], max_blocks_per_sm=BLOCKS_PER_SM,
    )


def int4_frontier_scores_plain(
    cur: torch.Tensor,
    queries: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    metric: MetricType,
) -> torch.Tensor:
    """Plain PyTorch version: gather the rows, dequantize, take distances."""
    idx = cur.long()
    vecs = decode_int4(codes[idx], scale[idx], queries.shape[-1])
    return pairwise_distance(queries[:, None, :], vecs, metric)


def _check(cur, queries, codes, scale, metric) -> torch.device:
    dev = check_tensors([
        ("cur", cur, torch.int32, 1),
        ("queries", queries, torch.float32, 2),
        ("codes", codes, torch.int32, 3),
        ("scale", scale, torch.float32, 2),
    ])
    B, D = queries.shape
    C, R, DW = codes.shape
    if cur.shape[0] != B:
        raise ValueError(f"cur has {cur.shape[0]} rows, queries {B}")
    if tuple(scale.shape) != (C, R):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {(C, R)}")
    if D > 8 * DW:
        raise ValueError(f"codes of {DW} words do not cover {D} dims")
    check_stage_fits(stage_bytes(R, D, DW), f"{R} rows of {DW} words")
    if metric not in METRIC_CODE:
        raise ValueError(f"Unsupported metric type {metric}")
    if C == 0 and B > 0:
        raise ValueError("codes table is empty")
    return dev


def int4_frontier_scores(
    cur: torch.Tensor,  # i32[B] current node slot per query
    queries: torch.Tensor,  # f32[B, D]
    codes: torch.Tensor,  # i32[C, R, ceil(D/8)] planar words
    scale: torch.Tensor,  # f32[C, R]
    *,
    metric: MetricType,
) -> torch.Tensor:
    """f32[B, R] approximate distances of every cached INT4 neighbor of each
    query's current node. CPU tensors: the plain version. CUDA tensors: the
    kernel, or an exception."""
    global LAUNCHES, LAST_PLAN
    if _check(cur, queries, codes, scale, metric).type == "cpu":
        return int4_frontier_scores_plain(
            cur, queries, codes, scale, metric=metric
        )
    B, D = queries.shape
    C, R, DW = codes.shape
    out = torch.empty((B, R), dtype=torch.float32, device=cur.device)
    if B == 0:
        return out
    plan = _launch_plan(cur, queries, codes, scale)
    launch(
        LIBRARY, (cur, queries, codes, scale, out),
        (B, D, C, R, DW, METRIC_CODE[metric], plan.grid, plan.stages,
         plan.stage_bytes, int(plan.bulk)),
    )
    LAUNCHES += 1
    LAST_PLAN = plan
    return out
