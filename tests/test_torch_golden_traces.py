"""Golden-trace parity of the PyTorch port: its ``beam_search`` against the
EXECUTED reference C.

The port's copy of layer 3 of ``tests/test_golden_traces.py``: on each
trace's first adjacency snapshot (the zombie-free post-build graph), the
port's beam search with FLOAT32 edges at E=1 reproduces the reference's
visit order and top-k row ids for every search before the first delete.
The traces' datasets are integer-valued, so f32 sums are order-invariant
and the distances reproduce bit for bit. No JAX runs here: the traces are
recorded data. The 20k-row trace stays under ``slow``, as in the JAX test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import EdgeType, MetricType
from duckdb_lm_diskann_tpu_torch.core.graph import (
    GraphParams,
    make_graph_arrays,
)
from duckdb_lm_diskann_tpu_torch.core.searcher import beam_search
from tests.test_golden_traces import (
    BIG_TRACES,
    BUILD_TRACES,
    first_snapshot,
    load,
    predelete_searches,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize(
    "name",
    BUILD_TRACES + ["l2_lifecycle_5k", "cos_lifecycle_5k"] + BIG_TRACES,
)
def test_port_matches_reference_search(name):
    """The searches of one trace run as one lock-step batch, each lane
    seeded with its own recorded start row (lanes are independent, so this
    equals one call per search)."""
    g, m, vecs = load(name)
    snap = first_snapshot(g)
    rowids = sorted(int(r) for r in snap["adj"])
    slot_of = {r: i for i, r in enumerate(rowids)}
    R = m["max_edges"]
    params = GraphParams(
        dims=m["dims"], r=R, metric=MetricType.parse(m["metric"]),
        edge_type=EdgeType.FLOAT32, alpha=m["alpha_x1000"] / 1000.0,
        l_insert=m["insert_l"], l_search=m["search_l"],
        max_visits=8 * m["search_l"],
    )
    cap = len(rowids)
    vmat = np.zeros((cap, m["dims"]), np.float32)
    nmat = np.full((cap, R), -1, np.int32)
    emat = np.zeros((cap, R, m["dims"]), np.float32)
    for r in rowids:
        s = slot_of[r]
        vmat[s] = vecs[r - 1]  # build scenarios: rowid r = vec r-1
        for j, e in enumerate(snap["adj"][str(r)]):
            nmat[s, j] = slot_of[e[0]]
            emat[s, j] = vecs[e[0] - 1]
    arrays = make_graph_arrays(params, cap, "cpu")._replace(
        vectors=torch.from_numpy(vmat),
        neighbors=torch.from_numpy(nmat),
        edge_f32=torch.from_numpy(emat),
        valid=torch.ones(cap, dtype=torch.bool),
    )
    ops = predelete_searches(g)
    assert ops
    by_k: dict[int, list] = {}
    for op in ops:
        by_k.setdefault(op["k"], []).append(op)
    for k, group in by_k.items():
        queries = torch.from_numpy(np.stack([vecs[op["vec"]] for op in group]))
        starts = torch.as_tensor(
            [[slot_of[op["start"]]] for op in group], dtype=torch.int32
        )
        res = beam_search(
            arrays, queries, starts, params=params, l_search=m["search_l"],
            k=k,
        )
        for b, op in enumerate(group):
            count = int(res.visited_count[b])
            visits = [rowids[s] for s in res.visited_slots[b, :count].tolist()]
            topk = [rowids[s] for s in res.topk_slots[b].tolist() if s >= 0]
            assert visits == op["visits"], f"{name}: search {b} visits"
            assert topk == op["topk"], f"{name}: search {b} top-k"
