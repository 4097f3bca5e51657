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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
        key = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
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
