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
with nvcc at first use into ``duckdb_lm_diskann_tpu_torch/_build/`` (keyed
on a hash of the source and flags, so a rebuilt checkout reuses it) and
bound with ctypes through a plain C entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from duckdb_lm_diskann_tpu.common.types import MetricType

from ..ops.distance import pairwise_distance
from ..ops.quantize import decode_int4

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "int4_frontier.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_METRIC_CODE = {MetricType.L2: 0, MetricType.IP: 1, MetricType.COSINE: 2}
_MAX_SMEM_BYTES = 48 * 1024  # the query row staged in shared memory

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
LAUNCHES = 0
# nvcc's output of the build this process ran (ptxas registers/spills), or
# "" when the library came from an earlier build.
BUILD_LOG = ""
_lib = None


def find_nvcc() -> str | None:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library. Raises
    RuntimeError with nvcc's output when nvcc is missing or fails."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    build_dir = BUILD_DIR
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = build_dir / f"int4_frontier_{key}.so"
    if not so.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH, $CUDA_HOME/bin): cannot build "
                f"{SOURCE.name} for a CUDA tensor"
            )
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} building "
                f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}"
            )
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.lmd_int4_frontier_scores
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


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


def _check(cur, queries, codes, scale, metric):
    dev = cur.device
    for name, t, dtype, ndim in (
        ("cur", cur, torch.int32, 1),
        ("queries", queries, torch.float32, 2),
        ("codes", codes, torch.int32, 3),
        ("scale", scale, torch.float32, 2),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cur on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"{name} must be {dtype} with {ndim} dims, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    if metric not in _METRIC_CODE:
        raise ValueError(f"Unsupported metric type {metric}")
    if C == 0 and B > 0:
        raise ValueError("codes table is empty")


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
    _check(cur, queries, codes, scale, metric)
    dev = cur.device
    if dev.type == "cpu":
        return int4_frontier_scores_plain(
            cur, queries, codes, scale, metric=metric
        )
    if dev.type != "cuda":
        raise ValueError(f"int4_frontier_scores: unsupported device {dev}")
    lib = load_library()
    B, D = queries.shape
    C, R, DW = codes.shape
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lmd_int4_frontier_scores(
            ctypes.c_void_p(cur.data_ptr()),
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(codes.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            B, D, C, R, DW, _METRIC_CODE[metric],
            ctypes.c_void_p(stream),
        )
        if err != 0:
            raise RuntimeError(
                f"int4_frontier_scores kernel launch failed: CUDA error {err}"
            )
        LAUNCHES += 1
    return out
