"""Row gathers with rows in flight: the hand-written Hopper kernel and its
plain form.

``pipelined_gather(idx, src, n_flight)`` returns ``src[idx]`` of one table
and ``pipelined_gather4(idx, tables, n_flight)`` the same index gathered
from four tables in one launch. They are the ports of the hop profiler's
TPU kernels ``_pipelined_gather`` and ``_pipelined_gather4``
(``benchmarks/profile_hop.py:251`` and ``:313``), the instruments that
measure the row-gather floor of a hop (``experiments/profile_hop.py``,
gather mode); the CUDA source is ``csrc/row_gather.cu``. Tables are int32
holding u32 bits (``.view(torch.int32)`` of f32 data), as everywhere in the
port. Indices are clamped into [0, C) by the kernel and the plain version
alike.

Dispatch follows the tensors, never a switch: CPU tensors take the plain
PyTorch version (``index_select``); CUDA tensors launch the kernel or raise.
The kernel's launch geometry (blocks, threads, row groups, column units and
their width per table) is ``_build.gather_plan`` of the call's sizes and
pointers; the last launch's is ``LAST_PLAN``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (
    GatherPlan,
    KernelLibrary,
    check_tensors,
    gather_plan,
    launch,
)

LIBRARY = KernelLibrary(
    "row_gather", "lmd_row_gather",
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
       ctypes.c_void_p],
)
N_FLIGHT = (4, 8, 16)  # the kernel's instantiations
THREADS = 256  # the kernel's kThreads (csrc/row_gather.cu)

# Kernel launches since the last reset, by entry point: LAUNCHES for
# pipelined_gather, LAUNCHES4 for pipelined_gather4 (chip_smoke.py reads and
# resets both), and the plan of the last launch.
LAUNCHES = 0
LAUNCHES4 = 0
LAST_PLAN: GatherPlan | None = None


def pipelined_gather_plain(idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``src[clamp(idx, 0, C-1)]``."""
    return src.index_select(0, idx.clamp(0, src.shape[0] - 1).long())


def _check(idx, tables, n_flight) -> torch.device:
    dev = check_tensors(
        [("idx", idx, torch.int32, 1)]
        + [(f"table {i}", t, torch.int32, 2) for i, t in enumerate(tables)]
    )
    C = tables[0].shape[0]
    if any(t.shape[0] != C for t in tables):
        raise ValueError(
            f"tables differ in rows: {[t.shape[0] for t in tables]}"
        )
    if C == 0 and idx.shape[0] > 0:
        raise ValueError("table is empty")
    if n_flight not in N_FLIGHT:
        raise ValueError(f"n_flight must be one of {N_FLIGHT}, got {n_flight}")
    return dev


def _gather(idx, tables, n_flight):
    global LAUNCHES, LAUNCHES4, LAST_PLAN
    if _check(idx, tables, n_flight).type == "cpu":
        return [pipelined_gather_plain(idx, t) for t in tables]
    B = idx.shape[0]
    outs = [
        torch.empty((B, t.shape[1]), dtype=torch.int32, device=idx.device)
        for t in tables
    ]
    plan = gather_plan(
        B, n_flight, [t.shape[1] for t in tables],
        [(t.data_ptr(), o.data_ptr()) for t, o in zip(tables, outs)], THREADS,
    )
    if plan.blocks == 0:  # no rows, or rows of width 0: nothing to launch
        return outs
    pad = 4 - len(tables)  # unused slots: width 0, never read
    srcs, dsts = list(tables) + [idx] * pad, outs + [idx] * pad
    widths = [t.shape[1] for t in tables] + [0] * pad
    launch(
        LIBRARY,
        (idx, *(p for pair in zip(srcs, dsts) for p in pair)),
        (*widths, len(tables), B, tables[0].shape[0], n_flight),
    )
    if len(tables) == 1:
        LAUNCHES += 1
    else:
        LAUNCHES4 += 1
    LAST_PLAN = plan
    return outs


def pipelined_gather(
    idx: torch.Tensor,  # i32[B] rows
    src: torch.Tensor,  # i32[C, X]
    n_flight: int = 8,
) -> torch.Tensor:
    """i32[B, X] = src[idx]. CPU tensors: the plain version. CUDA tensors:
    the kernel (``n_flight`` rows' loads in flight a thread), or an
    exception."""
    return _gather(idx, (src,), n_flight)[0]


def pipelined_gather4(
    idx: torch.Tensor,  # i32[B] rows
    tables,  # four i32[C, X_i]: (vectors, neighbors, scales, codes)
    n_flight: int = 8,
) -> list[torch.Tensor]:
    """The same index gathered from four tables in one launch: four
    i32[B, X_i]."""
    tables = tuple(tables)
    if len(tables) != 4:
        raise ValueError(f"expected four tables, got {len(tables)}")
    return _gather(idx, tables, n_flight)
