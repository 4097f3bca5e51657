"""Structural index verification — the real VerifyAndToString body (the
port's copy of ``duckdb_lm_diskann_tpu/utils/verify.py``; it reads the
graph tensors to the host).

The reference's BoundIndex contract includes VerifyAndToString
(db/LmDiskannIndex.cpp:576-604, a human-readable dump) and DuckDB's index
verification hooks. This module checks the graph invariants the engine
relies on and reports the statistics an operator needs:

  - bidirectional rowid<->slot map consistency and valid-mask agreement
  - entry point liveness
  - neighbor slots in range, no self-loops, degree <= R
  - zombie-edge fraction (edges to tombstoned slots — expected after
    deletes, swept at checkpoint)
  - reachability: BFS from the entry point over live out-edges (the
    property beam search actually needs; low reachability = lost recall)
"""

from __future__ import annotations

import numpy as np


class VerificationError(AssertionError):
    """A structural invariant is violated."""


def verify_graph(coord, check_reachability: bool = True) -> dict:
    """Verify a Coordinator's graph. Raises VerificationError on invariant
    violations; returns a statistics report."""
    nbrs = coord.arrays.neighbors.cpu().numpy()
    valid = coord.arrays.valid.cpu().numpy()
    cap = coord.capacity
    problems: list[str] = []

    live_slots = np.asarray(sorted(coord.allocator.slot_to_rowid), np.int64)
    for rowid, slot in coord.allocator.rowid_to_slot.items():
        if coord.allocator.slot_to_rowid.get(slot) != rowid:
            problems.append(f"map asymmetry rowid {rowid} slot {slot}")
        if slot >= cap or not valid[slot]:
            problems.append(f"live row {rowid} slot {slot} not valid")
    n_valid = int(valid.sum())
    if n_valid != len(live_slots):
        problems.append(
            f"valid mask count {n_valid} != mapped live rows {len(live_slots)}"
        )
    if coord.count and (
        coord.entry_slot < 0 or not valid[coord.entry_slot]
    ):
        problems.append("entry point is missing or tombstoned")

    report = {
        "count": coord.count,
        "capacity": cap,
        "entry_slot": coord.entry_slot,
    }
    if len(live_slots):
        rows = nbrs[live_slots]  # [L, R]
        present = rows >= 0
        if (rows >= cap).any():
            problems.append("neighbor slot out of range")
        if (rows == live_slots[:, None]).any():
            problems.append("self-loop edge")
        degrees = present.sum(axis=1)
        alive_edge = present & valid[np.clip(rows, 0, cap - 1)]
        zombies = int((present & ~alive_edge).sum())
        total_edges = int(present.sum())
        report.update(
            mean_degree=float(degrees.mean()),
            min_degree=int(degrees.min()),
            max_degree=int(degrees.max()),
            total_edges=total_edges,
            zombie_edges=zombies,
            zombie_fraction=zombies / max(total_edges, 1),
        )
        if check_reachability and coord.entry_slot >= 0:
            # BFS over live out-edges from the entry point (vectorized
            # frontier expansion on host; one gather per level).
            reach = np.zeros(cap, bool)
            frontier = np.asarray([coord.entry_slot])
            reach[frontier] = True
            while len(frontier):
                nxt = nbrs[frontier].ravel()
                # Clamp BOTH bounds: a corrupt out-of-range neighbor slot
                # must surface as the already-recorded problem report, not
                # crash the BFS with an IndexError.
                nxt = nxt[(nxt >= 0) & (nxt < cap)]
                nxt = nxt[valid[nxt] & ~reach[nxt]]
                nxt = np.unique(nxt)
                reach[nxt] = True
                frontier = nxt
            n_reach = int(reach[live_slots].sum())
            report["reachable"] = n_reach
            report["reachable_fraction"] = n_reach / max(len(live_slots), 1)
    else:
        report.update(
            mean_degree=0.0, min_degree=0, max_degree=0,
            total_edges=0, zombie_edges=0, zombie_fraction=0.0,
        )

    report["problems"] = problems
    if problems:
        raise VerificationError("; ".join(problems))
    return report
