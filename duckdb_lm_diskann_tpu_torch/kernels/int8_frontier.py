"""INT8 frontier scoring: the hand-written Hopper kernel and its plain form.

``int8_frontier_scores`` returns f32[B, R], the distance from each query to
the R dequantized INT8 neighbor codes cached in its current node's row. It
is the port of the TPU kernel ``int8_frontier_scores`` in
``duckdb_lm_diskann_tpu/experiments/pallas_kernels.py``; the CUDA source is
``csrc/int8_frontier.cu``.

Dispatch follows the tensors, never a switch: CPU tensors take the plain
PyTorch version (gather, ``decode_int8``, ``pairwise_distance``); CUDA
tensors launch the kernel or raise. The kernel's launch plan (persistent
grid, ring stages, bulk or vector branch) is ``_build.ring_plan`` of this
call's sizes and pointers; a node's R x D code block too large for two
stages of a block is scored in pieces of ``stage_rows`` rows.
"""

from __future__ import annotations

import ctypes

import torch

from ..common.types import MetricType
from ..ops.distance import pairwise_distance
from ..ops.quantize import decode_int8
from ._build import (
    BLOCK_SHARED_BYTES,
    METRIC_CODE,
    RING_STATIC_BYTES,
    KernelLibrary,
    RingPlan,
    check_tensors,
    launch,
    pad16,
    ring_plan,
    sm_count,
)

ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
LIBRARY = KernelLibrary("int8_frontier", "lmd_int8_frontier_scores", ARGTYPES)

# The kernel's kBlocksPerSm (csrc/int8_frontier.cu): the most blocks a SM holds.
BLOCKS_PER_SM = 8

# Kernel launches since the last reset (chip_smoke.py reads and resets it),
# and the plan of the last launch.
LAUNCHES = 0
LAST_PLAN: RingPlan | None = None


def stage_bytes(rows: int, D: int) -> int:
    """A ring stage of ``rows`` rows of a node (csrc/int8_frontier.cu,
    Layout): the codes, the scales, then the query-row window."""
    return pad16(rows * D) + pad16(rows * 4) + pad16(D * 4) + 16


def stage_rows(R: int, D: int) -> int:
    """Rows of a node's block one stage holds: all R where two stages fit
    a block's shared memory; else the most that do (from 4 on a multiple
    of 4, so that the pieces keep 16-byte scale blocks), at least 1."""
    room = (BLOCK_SHARED_BYTES - RING_STATIC_BYTES) // 2
    if stage_bytes(R, D) <= room:
        return R
    rows = 1
    while rows < R and stage_bytes(rows + 1, D) <= room:
        rows += 1
    return rows if rows < 4 else rows // 4 * 4


def _launch_plan(cur, queries, codes, scale) -> RingPlan:
    """The plan a launch on these CUDA tensors takes; raises ValueError
    where not even one row of a node and the query fit a stage."""
    B, D = queries.shape
    _, R, _ = codes.shape
    rows = stage_rows(R, D)
    last = R - (R - 1) // rows * rows  # rows of the node's last piece
    items = B * -(-R // rows)  # (query, piece) pairs
    if items >= 2**31:
        raise ValueError(f"{B} queries in pieces of {rows} of {R} rows")
    return ring_plan(
        items, sm_count(cur.device), stage_bytes(rows, D),
        pointers=[t.data_ptr() for t in (queries, codes, scale)],
        block_bytes=[R * D, R * 4, rows * D, rows * 4, last * D, last * 4],
        max_blocks_per_sm=BLOCKS_PER_SM,
    )


def int8_frontier_scores_plain(
    cur: torch.Tensor,
    queries: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    metric: MetricType,
) -> torch.Tensor:
    """Plain PyTorch version: gather the rows, dequantize, take distances."""
    idx = cur.long()
    vecs = decode_int8(codes[idx], scale[idx])
    return pairwise_distance(queries[:, None, :], vecs, metric)


def _check(cur, queries, codes, scale, metric) -> torch.device:
    dev = check_tensors([
        ("cur", cur, torch.int32, 1),
        ("queries", queries, torch.float32, 2),
        ("codes", codes, torch.int8, 3),
        ("scale", scale, torch.float32, 2),
    ])
    B, D = queries.shape
    C, R, CD = codes.shape
    if cur.shape[0] != B:
        raise ValueError(f"cur has {cur.shape[0]} rows, queries {B}")
    if CD != D:
        raise ValueError(f"codes of {CD} dims for queries of {D}")
    if tuple(scale.shape) != (C, R):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {(C, R)}")
    if metric not in METRIC_CODE:
        raise ValueError(f"Unsupported metric type {metric}")
    if C == 0 and B > 0:
        raise ValueError("codes table is empty")
    return dev


def int8_frontier_scores(
    cur: torch.Tensor,  # i32[B] current node slot per query
    queries: torch.Tensor,  # f32[B, D]
    codes: torch.Tensor,  # i8[C, R, D]
    scale: torch.Tensor,  # f32[C, R]
    *,
    metric: MetricType,
) -> torch.Tensor:
    """f32[B, R] approximate distances of every cached INT8 neighbor of each
    query's current node. CPU tensors: the plain version. CUDA tensors: the
    kernel, or an exception."""
    global LAUNCHES, LAST_PLAN
    if _check(cur, queries, codes, scale, metric).type == "cpu":
        return int8_frontier_scores_plain(
            cur, queries, codes, scale, metric=metric
        )
    B, D = queries.shape
    C, R, _ = codes.shape
    out = torch.empty((B, R), dtype=torch.float32, device=cur.device)
    if B == 0:
        return out
    plan = _launch_plan(cur, queries, codes, scale)
    launch(
        LIBRARY, (cur, queries, codes, scale, out),
        (B, D, C, R, METRIC_CODE[metric], stage_rows(R, D), plan.grid,
         plan.stages, plan.stage_bytes, int(plan.bulk)),
    )
    LAUNCHES += 1
    LAST_PLAN = plan
    return out
