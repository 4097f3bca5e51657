"""Side-by-side card times of the row-gather kernel, its bulk-copy
variant and ``torch.index_select``.

Usage, from the repository root, on a machine with a CUDA card and nvcc:

    python -m duckdb_lm_diskann_tpu_torch.experiments.row_gather_ab \\
        [--shapes 4x32 1x32 4x1] [--no-fence] [--knockouts]
        [--batches 1024 4096] [--rows N] [--reps N]

The builds: the shipped kernel (``csrc/row_gather.cu`` through
``kernels/row_gather.pipelined_gather``, n_flight = 8) and the bulk-copy
variant ``experiments/row_gather_bulk.cu`` (rows through shared memory by
1-D ``cp.async.bulk`` loads and stores), copied with ``csrc/ring.cuh``
under ``_build/ab/``. The variant runs once per block shape of
``--shapes`` (blocks a SM x the most issuing lanes a block; ``bulk_plan``
fits them to the shared memory); with ``--no-fence`` a copy without the
proxy fence before each bulk store runs at the first shape; with
``--knockouts`` copies that each leave out one part of the variant
(``KNOCKOUTS``: the idx read, the stores, the loads, everything but the
launch) run at the first shape, timed and never checked. Every build but a
knockout is first held against the plain version exactly at the measured
shape, then all are timed in turns with ``index_select`` (a, b, ...,
index_select, index_select, ..., b, a) over ``--rows`` rows (default 2^20,
as chip_smoke.py) of one 1280-word table (5,120-byte rows, the hop
profiler's combined row), on fresh rows for every call: by lone calls
behind a sleep kernel (``cuda_timing.device_ms``, median) and by a train
of back-to-back calls (``cuda_timing.device_ms_train``). Each number is the
mean of its two turns; the bound is the distinct rows read and the rows
written, with the index, over the card's HBM rate (``utils.roofline``).

Standard output: one JSON line per batch size (with each build's plan),
then the card's name and power limit; nvcc's ptxas lines go to standard
error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import row_gather as kg
from ..kernels._build import (
    BLOCK_SHARED_BYTES,
    BUILD_DIR,
    CSRC,
    SM_SHARED_BYTES,
    KernelLibrary,
    build_libraries,
    launch,
    sm_count,
)
from ..utils import cuda_timing
from ..utils.roofline import device_hbm_gbps

VARIANT = Path(__file__).resolve().parent / "row_gather_bulk.cu"
ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p]
)
X, K = 1280, 8


class _Copy(KernelLibrary):
    """The bulk-copy variant built from a copy of its source."""

    def __init__(self, name, path):
        super().__init__(name, "lmd_row_gather_bulk", ARGTYPES)
        self.path = Path(path)

    @property
    def source(self) -> Path:
        return self.path


def _variant_copy(label: str, texts=()) -> Path:
    src = VARIANT.read_text()
    for old, new in texts:
        if src.count(old) != 1:
            raise RuntimeError(f"row_gather_bulk.cu: no single {old.strip()!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "ab" / label
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "ring.cuh", out / "ring.cuh")
    (out / "row_gather_bulk.cu").write_text(src)
    return out / "row_gather_bulk.cu"


FENCE = ('    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n',
         "")

# Knockout copies of the variant (--knockouts): each removes one part of its
# chain, so its output is wrong and it is timed, never checked. Each entry:
# the texts to replace in row_gather_bulk.cu, and with what.
KNOCKOUTS = {
    # idx is never read: row m of a lane is a fixed function of its position.
    "no_idx": [("return clamp_row(idx[row(m)], C);",
                "return (row(m) * 7919) % C;")],
    # No bulk stores: loads and barrier waits only.
    "no_store": [(
        "        bulk_store(tabs.t[t].out + b * tabs.t[t].bytes, "
        "st + tabs.t[t].off,\n                   "
        "(uint32_t)tabs.t[t].bytes);",
        "        ;",
    )],
    # No bulk loads: the barrier is armed with 0 bytes, the stores write
    # whatever the stage holds.
    "no_load": [
        ("ring::mbar_arrive_expect_tx(full, tabs.stage_bytes);",
         "ring::mbar_arrive_expect_tx(full, 0);"),
        ("        ring::bulk_copy(st + tabs.t[t].off, tabs.t[t].src + r * "
         "tabs.t[t].bytes,\n                        "
         "(uint32_t)tabs.t[t].bytes, full);",
         "        ;"),
    ],
    # Every lane returns at once: the launch and the grid alone.
    "empty": [("  if (lane >= L || lane >= n_mine) return;", "  return;")],
}


def bulk_plan(n_rows: int, sms: int, stage_bytes: int, k: int,
              max_lanes: int) -> dict:
    """The variant's launch plan for ``n_rows`` >= 1 rows of
    ``stage_bytes``: grid = min(B, k * SMs) one-warp blocks, each issuing
    its R = ceil(B / grid) rows from L = min(max_lanes, R) lanes of one
    stage; k is halved until k such blocks fit a SM, and at k = 1 L shrinks
    until the block fits."""

    def smem(lanes):  # an 8-byte mbarrier a lane (padded to 128), the stages
        return -(-8 * lanes // 128) * 128 + lanes * stage_bytes

    if smem(1) > BLOCK_SHARED_BYTES:
        raise ValueError(f"bulk_plan: a {stage_bytes}-byte stage does not fit")
    while True:
        grid = min(n_rows, k * sms)
        lanes = min(max_lanes, -(-n_rows // grid))
        room = min(SM_SHARED_BYTES // k - 1024, BLOCK_SHARED_BYTES)
        if k == 1:
            while lanes > 1 and smem(lanes) > room:
                lanes -= 1
        if smem(lanes) <= room:
            return {"grid": grid, "blocks_per_sm": k, "lanes": lanes}
        k //= 2


def _builds(shapes, no_fence, knockouts):
    """{label: (library or None for the shipped kernel, (k, lanes))}."""
    out = {"shipped": (None, None)}
    first = tuple(int(v) for v in shapes[0].split("x"))
    bulk = _Copy("row_gather_bulk", _variant_copy("bulk"))
    for sh in shapes:
        out[f"bulk_{sh}"] = (bulk, tuple(int(v) for v in sh.split("x")))
    if no_fence:
        out[f"bulk_{shapes[0]}_nofence"] = (
            _Copy("row_gather_bulk_nofence",
                  _variant_copy("bulk_nofence", [FENCE])),
            first,
        )
    for name in KNOCKOUTS if knockouts else ():
        label = f"knockout_{name}"
        out[label] = (
            _Copy(f"row_gather_{label}", _variant_copy(label, KNOCKOUTS[name])),
            first,
        )
    return out


def _call(lib, shape, idx, src):
    if lib is None:
        return kg.pipelined_gather(idx, src, K), None
    B = idx.shape[0]
    out = torch.empty((B, src.shape[1]), dtype=torch.int32, device=idx.device)
    plan = bulk_plan(B, sm_count(idx.device), 4 * src.shape[1], *shape)
    launch(lib, (idx, src, out) + (idx,) * 6,
           (src.shape[1], 0, 0, 0, 1, B, src.shape[0], plan["grid"],
            plan["lanes"]))
    return out, plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["4x32", "1x32", "4x1"])
    ap.add_argument("--no-fence", action="store_true")
    ap.add_argument("--knockouts", action="store_true")
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_gather_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    builds = _builds(args.shapes, args.no_fence, args.knockouts)
    libs = {id(lib): lib for lib, _ in builds.values() if lib is not None}
    build_libraries([kg.LIBRARY, *libs.values()])
    for lib in (kg.LIBRARY, *libs.values()):
        ptxas = [ln for ln in lib.build_log.splitlines() if "ptxas" in ln]
        print(f"[row_gather_ab] {lib.name}: " + "\n  ".join(ptxas),
              file=sys.stderr)
    bytes_per_ms = device_hbm_gbps(torch.cuda.get_device_name(dev)) * 1e6

    gen = torch.Generator(device=dev).manual_seed(0x6AB)
    n, reps = args.rows, args.reps
    src = torch.randint(-(2**31), 2**31, (n, X), dtype=torch.int32,
                        device=dev, generator=gen)
    for b in args.batches:
        idx = torch.randint(0, n, (reps + 3, b), dtype=torch.int32,
                            device=dev, generator=gen)
        idx[:, 1::7] = idx[:, :1]  # repeated rows
        want = kg.pipelined_gather_plain(idx[0], src)
        plans = {}
        for label, (lib, shape) in builds.items():
            got, plan = _call(lib, shape, idx[0], src)
            torch.cuda.synchronize()
            if not label.startswith("knockout_") and not torch.equal(got,
                                                                    want):
                raise AssertionError(f"{label} B={b}: != plain")
            plans[label] = plan if plan else kg.LAST_PLAN._asdict()

        def run(lib, shape):
            return lambda i: _call(lib, shape, idx[3 + i], src)

        def library(i):
            return torch.index_select(src, 0, idx[3 + i])

        fns = {label: run(lib, sh) for label, (lib, sh) in builds.items()}
        fns["index_select"] = library
        order = list(fns) + list(reversed(fns))
        lone, train = {lb: [] for lb in fns}, {lb: [] for lb in fns}
        for label in order:
            fn = fns[label]
            for i in range(3):
                fn(i - 3)
            lone[label].append(float(np.median(cuda_timing.device_ms(fn, reps))))
            train[label].append(cuda_timing.device_ms_train(fn, reps))
        rows = [int(idx[i].unique().numel()) for i in range(3, 3 + reps)]
        bound_ms = (float(np.median(rows)) * 4 * X + b * (4 * X + 4)) / (
            bytes_per_ms
        )
        print(json.dumps({
            "B": b, "X": X, "n_flight": K, "rows": n, "order": order,
            "ms": {lb: float(np.mean(v)) for lb, v in lone.items()},
            "train_ms": {lb: float(np.mean(v)) for lb, v in train.items()},
            "turns_ms": lone, "train_turns_ms": train, "bound_ms": bound_ms,
            "plans": plans,
        }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
