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
through a plain C entry point.
"""

from __future__ import annotations

import ctypes

import torch

from ..common.types import MetricType
from ..ops.distance import pairwise_distance
from ..ops.quantize import decode_int4
from ._build import METRIC_CODE, KernelLibrary, check_tensors, launch

LIBRARY = KernelLibrary(
    "int4_frontier", "lmd_int4_frontier_scores",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
_MAX_SMEM_BYTES = 48 * 1024  # the query row staged in shared memory

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
LAUNCHES = 0


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
    if 8 * DW * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"{DW} words per row exceed the staged query limit")
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
    global LAUNCHES
    if _check(cur, queries, codes, scale, metric).type == "cpu":
        return int4_frontier_scores_plain(
            cur, queries, codes, scale, metric=metric
        )
    B, D = queries.shape
    C, R, DW = codes.shape
    out = torch.empty((B, R), dtype=torch.float32, device=cur.device)
    launch(
        LIBRARY, (cur, queries, codes, scale, out),
        (B, D, C, R, DW, METRIC_CODE[metric]),
    )
    LAUNCHES += 1
    return out
