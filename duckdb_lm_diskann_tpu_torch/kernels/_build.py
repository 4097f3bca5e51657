"""Build, bind and launch the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point. At
first use it is compiled by nvcc for sm_90a into a shared library under the
package's gitignored ``_build/`` directory, keyed on a hash of the source
and the flags (an unchanged source is not rebuilt), and loaded with ctypes.
A missing nvcc or a failed build raises: nothing falls back to the plain
PyTorch versions on the card.

``build_libraries`` starts one nvcc per source, all at once, and waits for
them together, so that a process that needs every kernel pays for the
slowest build rather than the sum.

``ring_plan`` is the launch plan of the frontier scorers' persistent
ring (``csrc/ring.cuh``): grid, stages and branch, from the card's SM count
and the tensors' sizes and alignment. ``gather_plan`` is the launch
geometry of the row gather (``csrc/row_gather.cu``). Both are plain
Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from ..common.types import MetricType

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The metric argument of the float scorers' C entry points.
METRIC_CODE = {MetricType.L2: 0, MetricType.IP: 1, MetricType.COSINE: 2}


def find_nvcc() -> str | None:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


class KernelLibrary:
    """One ``csrc/<name>.cu`` source and its C entry point ``symbol``.

    ``function()`` builds the library if needed and returns the ctypes
    function with its ``argtypes`` and an int return code (the CUDA error
    of the launch). ``build_log`` holds nvcc's output (ptxas registers and
    spills) of a build this process ran, else ""."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.build_log = ""
        self._fn = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        # Every header under csrc/ is part of the key: a source may include
        # any of them.
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}_{key}.so"

    def function(self):
        if self._fn is None:
            build_libraries([self])
        return self._fn

    def _bind(self, so: Path) -> None:
        fn = getattr(ctypes.CDLL(str(so)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn


def build_libraries(libraries: list[KernelLibrary]) -> None:
    """Build every library not yet loaded (one nvcc each, run together),
    then load them. Raises RuntimeError with nvcc's output when nvcc is
    missing or any build fails; a failed build leaves no file behind."""
    todo = [lib for lib in libraries if lib._fn is None]
    missing = [lib for lib in todo if not lib.library_path().exists()]
    if missing:
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH, $CUDA_HOME/bin): cannot build "
                f"{', '.join(lib.source.name for lib in missing)} for a "
                "CUDA tensor"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for lib in missing:
            so = lib.library_path()
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(lib.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((lib, so, tmp, proc))
        errors = []
        for lib, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(
                    f"nvcc failed with exit code {proc.returncode} building "
                    f"{lib.source.name}:\n{out}"
                )
                continue
            lib.build_log = out
            os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
    for lib in todo:
        lib._bind(lib.library_path())


def check_tensors(specs) -> torch.device:
    """The checks every wrapper makes before a launch. ``specs`` is a list
    of (name, tensor, dtype, ndim); every tensor must lie on the first
    one's device, with that dtype and rank, and be contiguous. Returns the
    device."""
    dev = specs[0][1].device
    for name, t, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {specs[0][0]} on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"{name} must be {dtype} with {ndim} dims, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launch(lib: KernelLibrary, tensors, ints) -> None:
    """Call ``lib``'s entry point with the tensors' device pointers, the
    int arguments and the current stream of the tensors' device; raise if
    the launch was refused."""
    dev = tensors[0].device
    fn = lib.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(ctypes.c_void_p(t.data_ptr()) for t in tensors),
            *ints,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"{lib.symbol} launch failed: CUDA error {err}")


# The persistent ring of the frontier scorers (csrc/ring.cuh). An H100 SM
# has 228 KB of shared memory, a block may use 227 KB of it, and each
# resident block reserves 1 KB; RING_STATIC_BYTES covers the ring's static
# mbarriers.
SM_SHARED_BYTES = 233_472
BLOCK_SHARED_BYTES = 232_448
RING_STATIC_BYTES = 128
RING_MAX_STAGES = 4  # ring.cuh's kMaxStages


class RingPlan(NamedTuple):
    grid: int  # persistent blocks: min(B, k * SMs)
    stages: int  # S, the queries a block has in flight
    bulk: bool  # 1-D bulk copies; else cp.async by every thread
    stage_bytes: int


def pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def check_stage_fits(stage_bytes: int, what: str) -> None:
    if stage_bytes > BLOCK_SHARED_BYTES - RING_STATIC_BYTES:
        raise ValueError(
            f"{what}: one stage of {stage_bytes} bytes exceeds the "
            f"{BLOCK_SHARED_BYTES - RING_STATIC_BYTES} bytes of shared memory "
            "a block may use"
        )


def ring_plan(n_queries: int, sm_count: int, stage_bytes: int, pointers,
              block_bytes, max_blocks_per_sm: int) -> RingPlan:
    """Launch plan of a ring scorer for ``n_queries`` >= 1.

    ``stage_bytes`` is one query's stage, ``pointers`` the data addresses
    of every table and query tensor, ``block_bytes`` the size of each
    per-node block a bulk copy reads, ``max_blocks_per_sm`` the kernel's
    ``kBlocksPerSm`` (a power of two). k, the blocks a SM holds, is the
    most of max_blocks_per_sm, half of it, ... 1 that leaves each block
    S >= 2 stages (S <= 4); where not even two stages fit, k = 1 and S = 1. The bulk branch needs every pointer
    16-byte aligned and every block a multiple of 16 bytes (a query row of
    another size is fetched as the 16-byte window around it); anything else
    takes the vector branch."""
    check_stage_fits(stage_bytes, "ring_plan")
    k = max_blocks_per_sm
    while True:
        per_block = min(
            SM_SHARED_BYTES // k - 1024, BLOCK_SHARED_BYTES
        ) - RING_STATIC_BYTES
        stages = min(RING_MAX_STAGES, per_block // stage_bytes)
        if stages >= 2 or k == 1:
            break
        k //= 2
    bulk = all(p % 16 == 0 for p in pointers) and all(
        n % 16 == 0 for n in block_bytes
    )
    return RingPlan(
        grid=min(n_queries, k * sm_count), stages=stages, bulk=bulk,
        stage_bytes=stage_bytes,
    )


class GatherPlan(NamedTuple):
    blocks: int  # the grid: ceil(groups * sum(units) / threads)
    threads: int  # a block's threads (the kernel's kThreads)
    groups: int  # ceil(B / n_flight): a thread's rows, loaded before a store
    units: tuple  # per table: a row's column units, one a thread
    vec: tuple  # per table: 16-byte units (else 4-byte words)


def gather_plan(n_rows: int, n_flight: int, widths, pointers,
                threads: int) -> GatherPlan:
    """Launch geometry of the row gather (``csrc/row_gather.cu``, whose
    entry point derives the same from the same arguments) for ``n_rows``
    rows of tables ``widths`` words wide; ``pointers`` are each table's
    (source, output) data addresses and ``threads`` the kernel's
    ``kThreads``. A table moves 16-byte units where its width is a multiple
    of 4 words and both its pointers are 16-byte aligned, else 4-byte
    words. The rows go in groups of ``n_flight``, and each thread owns one
    unit of every row of its group. Raises ValueError for a negative row
    count, an ``n_flight`` below 1, or a grid past 2^31 - 1 blocks (which
    the entry point refuses)."""
    if n_rows < 0 or n_flight < 1:
        raise ValueError(f"gather_plan: {n_rows} rows, n_flight {n_flight}")
    vec = tuple(
        w % 4 == 0 and src % 16 == 0 and out % 16 == 0
        for w, (src, out) in zip(widths, pointers)
    )
    units = tuple(w // 4 if v else w for w, v in zip(widths, vec))
    groups = -(-n_rows // n_flight)
    blocks = -(-groups * sum(units) // threads)
    if blocks > 0x7FFFFFFF:
        raise ValueError(f"gather_plan: a grid of {blocks} blocks")
    return GatherPlan(blocks, threads, groups, units, vec)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA card."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
