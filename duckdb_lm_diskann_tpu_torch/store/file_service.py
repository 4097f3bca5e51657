"""File-system service over graph.lmd: a ctypes binding to the native C++
block store, and a pure-Python block file with the same on-disk format.

The port's own copy of ``duckdb_lm_diskann_tpu/store/file_service.py`` and
its ``native/blockstore.cpp``. Implements the reference's
store::IFileSystemService surface (store/IFileSystemService.hpp:16-76 —
Open/Close/ReadBlock/WriteBlock/GetFileSize/Truncate/Sync over one data
file), for which the reference has no concrete implementation.

The header (magic, format version 3, block size, block count, clean flag)
is the JAX package's, so a graph.lmd written by either package opens in the
other.

Two differences from the JAX package, both deliberate:

  * The native library is built at first use (never at import) with g++
    into the package's gitignored ``_build/`` directory, keyed on a hash of
    the source and the flags, and loaded with ctypes.
  * A failed build raises with the compiler's log. Nothing falls back to
    :class:`PyBlockFile` silently: a caller that wants the Python store asks
    for it (``open_block_file(..., prefer_native=False)``). Every block file
    names its implementation in ``backend`` ("native" or "python").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = Path(__file__).resolve().parent / "native" / "blockstore.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_HEADER_SIZE = 4096
_MAGIC = 0x4C4D444B414E4E31
_FORMAT_VERSION = 3
_HEADER_FMT = "<QIIQII"  # magic, version, block_size, num_blocks, clean, rsvd


def library_path() -> Path:
    key = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"blockstore_{key}.so"


def build_native() -> Path:
    """Compile the native block store (g++) unless this source and these
    flags were already built. Returns the library's path; raises
    RuntimeError with the compiler's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Built under a private name and renamed into place, so processes that
    # build at the same time never load a half-written library.
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
            capture_output=True, text=True, timeout=300,
        )
    except OSError as exc:
        raise RuntimeError(f"cannot run g++ to build {_SOURCE.name}: {exc}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {_SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    lib.bs_open.restype = ctypes.c_void_p
    lib.bs_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int]
    lib.bs_close.argtypes = [ctypes.c_void_p]
    lib.bs_num_blocks.restype = ctypes.c_uint64
    lib.bs_num_blocks.argtypes = [ctypes.c_void_p]
    lib.bs_block_size.restype = ctypes.c_uint32
    lib.bs_block_size.argtypes = [ctypes.c_void_p]
    lib.bs_format_version.restype = ctypes.c_uint32
    lib.bs_format_version.argtypes = [ctypes.c_void_p]
    lib.bs_truncate.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.bs_write_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.bs_write_blocks_at.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p]
    lib.bs_read_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.bs_read_blocks_at.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p]
    lib.bs_sync.argtypes = [ctypes.c_void_p]
    lib.bs_file_size.restype = ctypes.c_int64
    lib.bs_file_size.argtypes = [ctypes.c_void_p]
    lib.bs_crc32_rows.restype = None
    lib.bs_crc32_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.bs_mark_dirty.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bs_clean_shutdown.restype = ctypes.c_int
    lib.bs_clean_shutdown.argtypes = [ctypes.c_void_p]
    lib.bs_submit_write.restype = ctypes.c_uint64
    lib.bs_submit_write.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.bs_submit_write_at.restype = ctypes.c_uint64
    lib.bs_submit_write_at.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p]
    lib.bs_submit_sync.restype = ctypes.c_uint64
    lib.bs_submit_sync.argtypes = [ctypes.c_void_p]
    lib.bs_job_wait.restype = ctypes.c_int
    lib.bs_job_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.bs_async_pending.restype = ctypes.c_uint64
    lib.bs_async_pending.argtypes = [ctypes.c_void_p]
    lib.bs_async_error.restype = ctypes.c_int
    lib.bs_async_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class NativeBlockFile:
    """ctypes wrapper over the C++ store."""

    backend = "native"

    def __init__(self, path: str | os.PathLike, block_size: int, create=True):
        self._lib = _load_lib()
        self._h = self._lib.bs_open(
            str(path).encode(), block_size, 1 if create else 0)
        if not self._h:
            raise IOError(f"bs_open failed for {path}")
        self.block_size = block_size

    @property
    def num_blocks(self) -> int:
        return self._lib.bs_num_blocks(self._h)

    def write_blocks(self, first_idx: int, blocks: np.ndarray) -> None:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        rc = self._lib.bs_write_blocks(
            self._h, first_idx, blocks.shape[0],
            blocks.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError(f"bs_write_blocks rc={rc}")

    def write_blocks_at(self, indices: np.ndarray, blocks: np.ndarray) -> None:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        idx = np.ascontiguousarray(indices, np.uint64)
        rc = self._lib.bs_write_blocks_at(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), blocks.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError(f"bs_write_blocks_at rc={rc}")

    def read_blocks(self, first_idx: int, n: int) -> np.ndarray:
        out = np.empty((n, self.block_size), np.uint8)
        rc = self._lib.bs_read_blocks(
            self._h, first_idx, n, out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError(f"bs_read_blocks rc={rc}")
        return out

    def read_blocks_at(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.uint64)
        out = np.empty((len(idx), self.block_size), np.uint8)
        rc = self._lib.bs_read_blocks_at(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError(f"bs_read_blocks_at rc={rc}")
        return out

    def crc32_rows(self, blocks: np.ndarray) -> np.ndarray:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        out = np.empty(blocks.shape[0], np.uint32)
        self._lib.bs_crc32_rows(
            blocks.ctypes.data_as(ctypes.c_char_p), blocks.shape[0],
            blocks.shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out

    def truncate(self, num_blocks: int) -> None:
        rc = self._lib.bs_truncate(self._h, num_blocks)
        if rc != 0:
            raise IOError(f"bs_truncate rc={rc}")

    def sync(self) -> None:
        rc = self._lib.bs_sync(self._h)
        if rc != 0:
            raise IOError(f"bs_sync rc={rc}")

    def file_size(self) -> int:
        return self._lib.bs_file_size(self._h)

    def mark_dirty(self, dirty: bool) -> None:
        self._lib.bs_mark_dirty(self._h, 1 if dirty else 0)

    @property
    def clean_shutdown(self) -> bool:
        return bool(self._lib.bs_clean_shutdown(self._h))

    # -- async flush (background writer thread in the native store; the V2
    #    flush-daemon design, Consolidated Proposal:96-107). Jobs copy
    #    their payload, run strictly in submission order, and the first
    #    failure is sticky (fail-stop). Do not mix with synchronous writes
    #    while jobs are pending; ``flush_wait`` drains the pipeline.

    def submit_write(self, first_idx: int, blocks: np.ndarray) -> int:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        return self._lib.bs_submit_write(
            self._h, first_idx, blocks.shape[0],
            blocks.ctypes.data_as(ctypes.c_char_p))

    def submit_write_at(self, indices: np.ndarray, blocks: np.ndarray) -> int:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        idx = np.ascontiguousarray(indices, np.uint64)
        return self._lib.bs_submit_write_at(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), blocks.ctypes.data_as(ctypes.c_char_p))

    def submit_sync(self) -> int:
        return self._lib.bs_submit_sync(self._h)

    def flush_wait(self, job_id: int) -> None:
        rc = self._lib.bs_job_wait(self._h, job_id)
        if rc != 0:
            raise IOError(f"async flush failed rc={rc}")

    def async_pending(self) -> int:
        return self._lib.bs_async_pending(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.bs_close(self._h)
            self._h = None


class PyBlockFile:
    """Pure-Python block file, byte-identical on-disk format."""

    backend = "python"

    def __init__(self, path: str | os.PathLike, block_size: int, create=True):
        self.path = str(path)
        self.block_size = block_size
        mode = "r+b" if os.path.exists(self.path) else ("w+b" if create else None)
        if mode is None:
            raise IOError(f"{path} does not exist")
        self._f = open(self.path, mode)
        self._f.seek(0, 2)
        if self._f.tell() >= _HEADER_SIZE:
            self._read_header()
            if self.magic != _MAGIC or self._block_size_hdr != block_size:
                raise IOError("bad header")
        else:
            self.num_blocks = 0
            self.clean = 1
            self._write_header()

    def _read_header(self):
        self._f.seek(0)
        raw = self._f.read(struct.calcsize(_HEADER_FMT))
        (self.magic, self.version, self._block_size_hdr,
         self.num_blocks, self.clean, _) = struct.unpack(_HEADER_FMT, raw)

    def _write_header(self):
        self.magic = _MAGIC
        self.version = _FORMAT_VERSION
        self._block_size_hdr = self.block_size
        page = bytearray(_HEADER_SIZE)
        page[: struct.calcsize(_HEADER_FMT)] = struct.pack(
            _HEADER_FMT, _MAGIC, _FORMAT_VERSION, self.block_size,
            self.num_blocks, self.clean, 0)
        self._f.seek(0)
        self._f.write(page)

    def _off(self, idx):
        return _HEADER_SIZE + idx * self.block_size

    def write_blocks(self, first_idx: int, blocks: np.ndarray) -> None:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        self._f.seek(self._off(first_idx))
        self._f.write(blocks.tobytes())
        self.num_blocks = max(self.num_blocks, first_idx + blocks.shape[0])
        self._write_header()

    def write_blocks_at(self, indices, blocks: np.ndarray) -> None:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        for i, idx in enumerate(indices):
            self._f.seek(self._off(int(idx)))
            self._f.write(blocks[i].tobytes())
            self.num_blocks = max(self.num_blocks, int(idx) + 1)
        self._write_header()

    def read_blocks(self, first_idx: int, n: int) -> np.ndarray:
        self._f.seek(self._off(first_idx))
        raw = self._f.read(n * self.block_size)
        return np.frombuffer(raw, np.uint8).reshape(n, self.block_size).copy()

    def read_blocks_at(self, indices) -> np.ndarray:
        out = np.empty((len(indices), self.block_size), np.uint8)
        for i, idx in enumerate(indices):
            self._f.seek(self._off(int(idx)))
            out[i] = np.frombuffer(self._f.read(self.block_size), np.uint8)
        return out

    def crc32_rows(self, blocks: np.ndarray) -> np.ndarray:
        blocks = np.ascontiguousarray(blocks, np.uint8)
        return np.asarray(
            [zlib.crc32(blocks[i].tobytes()) for i in range(blocks.shape[0])],
            np.uint32)

    def truncate(self, num_blocks: int) -> None:
        self._f.truncate(self._off(num_blocks))
        self.num_blocks = num_blocks
        self._write_header()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def file_size(self) -> int:
        self._f.seek(0, 2)
        return self._f.tell()

    def mark_dirty(self, dirty: bool) -> None:
        self.clean = 0 if dirty else 1
        self._write_header()

    @property
    def clean_shutdown(self) -> bool:
        return bool(self.clean)

    # -- async flush: one daemon writer thread + bounded queue, with the
    #    native engine's ordering and fail-stop semantics.

    _MAX_QUEUE_BYTES = 256 << 20

    def _ensure_async(self):
        if getattr(self, "_aq", None) is None:
            import queue
            import threading

            self._aq = queue.Queue()
            self._a_err = None
            self._a_done = 0
            self._a_next = 1
            self._a_cv = threading.Condition()
            self._a_budget = self._MAX_QUEUE_BYTES

            def worker():
                while True:
                    item = self._aq.get()
                    if item is None:
                        return
                    job_id, fn, nbytes = item
                    try:
                        if self._a_err is None:
                            fn()
                    except Exception as exc:  # sticky fail-stop
                        if self._a_err is None:
                            self._a_err = exc
                    with self._a_cv:
                        self._a_done = job_id
                        self._a_budget += nbytes
                        self._a_cv.notify_all()

            self._a_thread = threading.Thread(target=worker, daemon=True)
            self._a_thread.start()

    def _submit(self, fn, nbytes: int) -> int:
        self._ensure_async()
        with self._a_cv:
            while self._a_budget < nbytes and self._a_done < self._a_next - 1:
                self._a_cv.wait()
            job_id = self._a_next
            self._a_next += 1
            self._a_budget -= nbytes
        self._aq.put((job_id, fn, nbytes))
        return job_id

    def submit_write(self, first_idx: int, blocks: np.ndarray) -> int:
        blocks = np.ascontiguousarray(blocks, np.uint8).copy()
        return self._submit(
            lambda: self.write_blocks(first_idx, blocks), blocks.nbytes)

    def submit_write_at(self, indices, blocks: np.ndarray) -> int:
        blocks = np.ascontiguousarray(blocks, np.uint8).copy()
        idx = np.asarray(indices).copy()
        return self._submit(
            lambda: self.write_blocks_at(idx, blocks), blocks.nbytes)

    def submit_sync(self) -> int:
        return self._submit(self.sync, 0)

    def flush_wait(self, job_id: int) -> None:
        if getattr(self, "_aq", None) is None:
            return
        with self._a_cv:
            while self._a_done < job_id:
                self._a_cv.wait()
        if self._a_err is not None:
            raise IOError(f"async flush failed: {self._a_err}")

    def async_pending(self) -> int:
        if getattr(self, "_aq", None) is None:
            return 0
        with self._a_cv:
            return (self._a_next - 1) - self._a_done

    def close(self) -> None:
        # Leaves the clean flag untouched (see blockstore.cpp bs_close):
        # only mark_dirty(False) after a committed checkpoint marks clean.
        if getattr(self, "_aq", None) is not None:
            try:
                self.flush_wait(self._a_next - 1)  # drain
            except IOError:
                pass  # close never raises; the dirty flag records the state
            self._aq.put(None)
            self._a_thread.join()
            self._aq = None
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None


def open_block_file(path, block_size: int, create=True, prefer_native=True):
    """Open graph.lmd with the native store (``prefer_native``, the
    default; a failed build raises) or with :class:`PyBlockFile`."""
    if prefer_native:
        return NativeBlockFile(path, block_size, create=create)
    return PyBlockFile(path, block_size, create=create)
