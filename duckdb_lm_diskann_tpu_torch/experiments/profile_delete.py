"""Phase split of ``Coordinator.delete`` on one CUDA card.

The port of ``benchmarks/profile_delete.py``. It splits one delete batch
into the phases ``Coordinator.delete`` reports through its ``on_phase``
hook: host planning ("plan": the deleted rows' neighbor lists read to the
host and grouped into repair rounds), "repair_rounds", "tombstone",
orphan "rescue" and its edge-code "refresh", and host "bookkeeping". The
card is synchronized (``torch.cuda.synchronize``) at the end of every
phase, so each phase's time includes its device work.

``profile(coord, rowids)`` times one delete of an already built
Coordinator (``chip_smoke.py`` does, on the INT4 headline graph). Run
alone,

    python -m duckdb_lm_diskann_tpu_torch.experiments.profile_delete [N] [DEL]

it builds an INT4 L2 index of N random 128-d rows (default 200,000; R=64,
L_insert=128, build batches of 2048) and times three delete batches of DEL
rows (default 1,000): a cold one and two steady ones.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..core.builder import plan_delete_repair


def profile(coord, rowids) -> dict:
    """Delete ``rowids`` from ``coord`` with every phase fenced. Returns
    the rows deleted, the total and per-row milliseconds, each phase's
    milliseconds, and the repair plan's round and target counts."""
    dev = coord.device
    rowids = [int(r) for r in rowids]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # The plan's shape, read before the timed call (the call plans again).
    slots = coord.allocator.lookup_slots(rowids)
    slots = np.unique(slots[slots >= 0]).astype(np.int32)
    nbr_rows = coord.arrays.neighbors[
        torch.as_tensor(slots, device=dev).long()
    ].cpu().numpy()
    rounds, rescue = plan_delete_repair(nbr_rows, slots, coord.params.r)

    marks = []

    def on_phase(name):
        sync()
        marks.append((name, time.perf_counter()))

    sync()
    t0 = time.perf_counter()
    n = coord.delete(rowids, on_phase=on_phase)
    phases, prev = {}, t0
    for name, t in marks:
        phases[name] = 1e3 * (t - prev)
        prev = t
    total = 1e3 * (prev - t0)
    return {
        "rows": n,
        "total_ms": total,
        "ms_per_row": total / max(n, 1),
        "phases_ms": phases,
        "rounds": len(rounds),
        "round_targets": [len(t) for t, _ in rounds[:4]],
        "rescue_targets": 0 if rescue is None else len(rescue[0]),
    }


def main(argv) -> int:
    from ..common.types import EdgeType, MetricType, VectorType
    from ..core.config import LmDiskannConfig
    from ..core.coordinator import Coordinator

    n = int(argv[0]) if len(argv) > 0 else 200_000
    nd = int(argv[1]) if len(argv) > 1 else 1000
    dims = 128
    rng = np.random.default_rng(0xDE1)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=64, l_insert=128, alpha=1.2,
        l_search=100, dimensions=dims,
        node_vector_type=VectorType.FLOAT32, edge_type=EdgeType.INT4,
    )
    cfg.validate()
    t0 = time.perf_counter()
    coord = Coordinator(cfg, initial_capacity=n)
    coord.bulk_build(range(n), data, max_batch=2048)
    torch.cuda.synchronize()
    print(f"# built n={n} in {time.perf_counter() - t0:.1f} s", flush=True)
    picks = rng.choice(n, 3 * nd, replace=False)
    for i, tag in enumerate(("cold", "steady1", "steady2")):
        rec = profile(coord, picks[i * nd : (i + 1) * nd])
        print(json.dumps({"batch": tag, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
