"""What the insert path's undo journal costs a bulk build, on one CUDA card.

Every insert batch of ``Coordinator.insert`` runs with an undo journal
(``core/builder.UndoJournal``: each writer saves the rows it overwrites, so
that a failed step rolls back exactly). This builds the headline's corpus
(``make_corpus(N, 128)``, L2, INT4, R=64, L_insert=128, build batches of
2048) in one process, after an untimed warm-up build of 16,384 rows, in
turns: journaled, without a journal, without, journaled; and prints each
build's seconds and the medians. The builds must give identical neighbor
tables.

    python -m duckdb_lm_diskann_tpu_torch.experiments.journal_ab [N]

N defaults to 262,144.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..common.types import EdgeType, MetricType, VectorType
from ..core.builder import insert_batch
from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..utils.corpora import make_corpus


class UnjournaledCoordinator(Coordinator):
    """The Coordinator with its insert batches run without a journal."""

    def _insert_step(self, arrays, slots, vectors, entry_slot, all_valid, rec):
        insert_batch(arrays, slots, vectors, entry_slot, self.params,
                     all_valid=all_valid, rec=rec)


def main(argv) -> int:
    n = int(argv[0]) if argv else 262_144
    if not torch.cuda.is_available():
        raise SystemExit("journal_ab: CUDA is not available")
    gen, _ = make_corpus(n, 128, seed=0xBE7C4)
    data = gen(n)
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=64, l_insert=128, alpha=1.2,
        l_search=100, dimensions=128, node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.INT4,
    )
    cfg.validate()
    # Warm-up: the process's first build pays one-time allocations.
    Coordinator(cfg, initial_capacity=16_384).bulk_build(
        range(16_384), data[:16_384], max_batch=2048)
    times = {"journal": [], "none": []}
    tables = {}
    for kind in ("journal", "none", "none", "journal"):
        cls = Coordinator if kind == "journal" else UnjournaledCoordinator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coord = cls(cfg, initial_capacity=n)
        coord.bulk_build(range(n), data, max_batch=2048)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
        nbrs = coord.arrays.neighbors.cpu().numpy()
        if kind in tables and not np.array_equal(tables[kind], nbrs):
            print(f"# {kind}: two builds differ", flush=True)
        tables.setdefault(kind, nbrs)
        print(json.dumps({"build": kind, "n": n, "s": times[kind][-1]}),
              flush=True)
        del coord
        torch.cuda.empty_cache()
    same = bool(np.array_equal(tables["journal"], tables["none"]))
    print(json.dumps({
        "n": n,
        "card": torch.cuda.get_device_name(0),
        "journal_s": times["journal"],
        "none_s": times["none"],
        "median_ratio": float(np.median(times["journal"])
                              / np.median(times["none"])),
        "tables_identical": same,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
