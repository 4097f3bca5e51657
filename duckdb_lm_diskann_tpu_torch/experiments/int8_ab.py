"""Side-by-side card times of variants of the INT8 frontier kernel.

Usage, from the repository root, on a machine with a CUDA card and nvcc:

    python -m duckdb_lm_diskann_tpu_torch.experiments.int8_ab \
        [--shapes 128x8 128x6] [--old PATH] [--rows N] [--reps N]

Each variant is a copy of the sources, built like the shipped kernel: for
each block shape of ``--shapes`` (threads x blocks a SM) a copy of
``csrc/int8_frontier.cu`` and ``csrc/ring.cuh`` under ``_build/ab/`` with
its ``kThreads`` and ``kBlocksPerSm`` rewritten (the launch plan follows
the blocks a SM), and with ``--old`` another source of the same contract
behind the first design's C entry point (``lmd_int8_frontier_scores(cur,
queries, codes, scale, out, B, D, C, R, metric, stream)``: one block per
query), e.g. an earlier commit's ``csrc/int8_frontier.cu``. Each build is
first held against the plain version at the measured shape (rtol = atol =
1e-5), then all are timed in turns (a, b, ..., b, a) at B = 1024 and 2048
over ``--rows`` rows (default 2^20, as chip_smoke.py), R = 64, D = 128,
L2, on fresh rows for every call: by lone calls behind a sleep kernel
(``cuda_timing.device_ms``, median) and by a train of back-to-back calls
(``cuda_timing.device_ms_train``). Each build's number is the mean of its
two turns; the bound is the distinct rows' bytes and the fixed bytes over
the card's HBM rate (``utils.roofline``).

Standard output: one JSON line per batch size, then the card's name and
power limit; nvcc's ptxas lines go to standard error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..common.types import MetricType
from ..kernels import int8_frontier as k8
from ..kernels._build import (
    BUILD_DIR,
    CSRC,
    KernelLibrary,
    build_libraries,
    launch,
    ring_plan,
    sm_count,
)
from ..utils import cuda_timing
from ..utils.roofline import device_hbm_gbps

OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
R, D = 64, 128


class _Copy(KernelLibrary):
    """The INT8 kernel built from another source file."""

    def __init__(self, name, path, argtypes):
        super().__init__(name, k8.LIBRARY.symbol, argtypes)
        self.path = Path(path)

    @property
    def source(self) -> Path:
        return self.path


def _shape_copy(threads: int, blocks: int) -> Path:
    src = (CSRC / "int8_frontier.cu").read_text()
    for name, value in (("kThreads", threads), ("kBlocksPerSm", blocks)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"int8_frontier.cu: no single {name}")
    out = BUILD_DIR / "ab" / f"{threads}x{blocks}"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "ring.cuh", out / "ring.cuh")
    (out / "int8_frontier.cu").write_text(src)
    return out / "int8_frontier.cu"


def _builds(shapes, old):
    """{label: (library, blocks a SM, or None for the first design)}."""
    out = {}
    if old:
        out["old"] = (_Copy("int8_frontier_old", old, OLD_ARGTYPES), None)
    for shape in shapes:
        threads, blocks = (int(x) for x in shape.split("x"))
        out[f"ring_{shape}"] = (
            _Copy(f"int8_frontier_{shape}", _shape_copy(threads, blocks),
                  k8.ARGTYPES),
            blocks,
        )
    return out


def _call(lib, k, cur, q, codes, scale):
    B, C = cur.shape[0], codes.shape[0]
    out = torch.empty((B, R), dtype=torch.float32, device=cur.device)
    tensors = (cur, q, codes, scale, out)
    if k is None:
        launch(lib, tensors, (B, D, C, R, 0))
        return out
    plan = ring_plan(B, sm_count(cur.device), k8.stage_bytes(R, D),
                     [t.data_ptr() for t in (q, codes, scale)],
                     [R * D, R * 4], k)
    launch(lib, tensors, (B, D, C, R, 0, R, plan.grid, plan.stages,
                          plan.stage_bytes, int(plan.bulk)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["128x8", "128x6"])
    ap.add_argument("--old", default=None)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    builds = _builds(args.shapes, args.old)
    build_libraries([lib for lib, _ in builds.values()])
    for label, (lib, _) in builds.items():
        ptxas = [ln for ln in lib.build_log.splitlines() if "ptxas" in ln]
        print(f"[int8_ab] {label}: " + "\n  ".join(ptxas), file=sys.stderr)
    bytes_per_ms = device_hbm_gbps(torch.cuda.get_device_name(dev)) * 1e6

    gen = torch.Generator(device=dev).manual_seed(0x1B8AB)
    n, reps = args.rows, args.reps
    codes = torch.randint(-128, 128, (n, R, D), dtype=torch.int8, device=dev,
                          generator=gen)
    scale = 0.005 * torch.rand((n, R), device=dev, generator=gen)
    scale[:, ::8] = 0.0
    for b in (1024, 2048):
        q = 0.3 * torch.randn((b, D), device=dev, generator=gen)
        curs = torch.randint(0, n, (reps + 3, b), dtype=torch.int32,
                             device=dev, generator=gen)
        curs[:, 1::7] = curs[:, :1]  # repeated rows
        want = k8.int8_frontier_scores_plain(curs[0], q, codes, scale,
                                             metric=MetricType.L2)
        for label, (lib, k) in builds.items():
            got = _call(lib, k, curs[0], q, codes, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{label} B={b}: {m}")

        def run(lib, k):
            return lambda i: _call(lib, k, curs[3 + i], q, codes, scale)

        order = list(builds) + list(reversed(builds))
        lone, train = {lb: [] for lb in builds}, {lb: [] for lb in builds}
        for label in order:
            lib, k = builds[label]
            for i in range(3):
                _call(lib, k, curs[i], q, codes, scale)
            lone[label].append(float(np.median(
                cuda_timing.device_ms(run(lib, k), reps))))
            train[label].append(cuda_timing.device_ms_train(run(lib, k), reps))
        rows = [int(curs[i].unique().numel()) for i in range(3, 3 + reps)]
        bound_ms = (float(np.median(rows)) * R * (D + 4)
                    + b * (4 * D + 4 + 4 * R)) / bytes_per_ms
        print(json.dumps({
            "B": b, "R": R, "D": D, "rows": n, "order": order,
            "ms": {lb: float(np.mean(v)) for lb, v in lone.items()},
            "train_ms": {lb: float(np.mean(v)) for lb, v in train.items()},
            "turns_ms": lone, "train_turns_ms": train, "bound_ms": bound_ms,
        }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
