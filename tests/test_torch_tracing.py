"""The port's span recorder (``utils/tracing.py``) and the benchmark's
readers of it (``lmdbench/spans.py``).

Off, a search or an insert records nothing; on, it gives the same answers
and the span tree of the recorder's docstring: one root a public call,
every span inside its parent, one merge a hop and a loop-condition read
every ``_CHECK_EVERY``-th iteration. A profiler session switches the
recorder on for its length. The ``cuda`` test runs on the card and skips
without one; this file imports nothing of JAX.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import (
    EdgeType,
    MetricType,
    VectorType,
)
from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.searcher import (
    _CHECK_EVERY,
    search_for_initial_candidates,
)
from duckdb_lm_diskann_tpu_torch.utils import tracing
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

N, DIMS, NQ = 400, 16, 12

# Each search span's parent.
SEARCH_PARENT = {
    "search.seed": "search",
    "search.check": "search",
    "search.hop": "search",
    "search.rerank": "search",
    "search.readback": "search",
    "search.hop.visit": "search.hop",
    "search.hop.score": "search.hop",
    "search.hop.merge": "search.hop",
    "search.hop.log": "search.hop",
}
# The parts of one insert step, in order.
STEP_PARTS = ("insert.store", "insert.candidates", "insert.prune",
              "insert.write", "insert.reciprocal", "insert.force")

# Coordinator.search options of each search path.
SEARCH_MODES = {
    "lockstep": {},
    "beam2": {"beam_width": 2},
    "batched": {"batch_size": 5},
    "stream": {"stream": True, "lanes": 4},
}


def _config(metric="l2", edge="int4", dims=DIMS):
    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(metric), r=8, l_insert=16, l_search=32,
        dimensions=dims, node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.parse(edge),
    )
    cfg.validate()
    return cfg


def _data(seed=0x7ACE, n=N, dims=DIMS):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    queries = data[rng.integers(0, n, NQ)] + 0.05 * rng.standard_normal(
        (NQ, dims)).astype(np.float32)
    return data, queries


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and no spans."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def built():
    data, queries = _data()
    coord = Coordinator(_config(), initial_capacity=N, device="cpu")
    coord.bulk_build(range(N), data, max_batch=64)
    return coord, queries


def _traced(fn):
    tracing.enable()
    try:
        return fn()
    finally:
        tracing.disable()


def _stats(coord):
    st = dataclasses.asdict(coord.last_search_stats)
    del st["wall_time_s"]
    return st


def _assert_nested(spans):
    """One call id and one root; each span inside its parent's interval."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1
    assert {s.call for s in spans} == {roots[0].id}
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s.name, p.name)
    return by_id


@pytest.mark.parametrize("mode", list(SEARCH_MODES))
def test_search_records_nothing_off_and_the_same_answers_on(built, mode):
    coord, queries = built
    opts = SEARCH_MODES[mode]
    ids, dists = coord.search(queries, 5, **opts)
    stats = _stats(coord)
    assert tracing.spans() == []
    ids_on, dists_on = _traced(lambda: coord.search(queries, 5, **opts))
    np.testing.assert_array_equal(ids_on, ids)
    np.testing.assert_array_equal(dists_on, dists)
    assert _stats(coord) == stats
    assert tracing.spans()


@pytest.mark.parametrize("max_batch", [1, 64])
def test_insert_records_nothing_off_and_the_same_graph_on(max_batch):
    data, _ = _data(n=120)
    graphs = []
    for on in (False, True):
        coord = Coordinator(_config(), initial_capacity=128, device="cpu")
        if on:
            tracing.enable()
        try:
            coord.bulk_build(range(120), data, max_batch=max_batch)
        finally:
            tracing.disable()
        assert bool(tracing.spans()) == on
        graphs.append(coord.arrays.to_numpy())
    for name, off, on in zip(graphs[0]._fields, *graphs):
        np.testing.assert_array_equal(on, off, err_msg=name)


def _check_pattern(names):
    """``search.check`` before every ``_CHECK_EVERY``-th hop of a loop and
    once after its last hop when that read ended it."""
    hops = names.count("search.hop")
    want = []
    for i in range(hops):
        if i % _CHECK_EVERY == 0:
            want.append("search.check")
        want.append("search.hop")
    if hops % _CHECK_EVERY == 0:
        want.append("search.check")
    assert names == want


@pytest.mark.parametrize("mode", ["lockstep", "batched", "stream"])
def test_one_search_builds_the_span_tree(built, mode):
    coord, queries = built
    _traced(lambda: coord.search(queries, 5, l_search=24,
                                 **SEARCH_MODES[mode]))
    spans = tracing.spans()
    by_id = _assert_nested(spans)
    root = next(s for s in spans if s.parent is None)
    assert root.name == "search"
    assert root.attrs == {"k": 5, "queries": NQ, "l_search": 24}
    for s in spans:
        if s.parent is not None:
            assert SEARCH_PARENT[s.name] == by_id[s.parent].name, s.name
    count = collections.Counter(s.name for s in spans)
    assert count["search.hop"] > 0
    for part in ("search.hop.visit", "search.hop.score", "search.hop.merge"):
        assert count[part] == count["search.hop"], part
    assert count["search.readback"] == 1
    seeds = count["search.seed"]
    assert seeds == (3 if mode == "batched" else 1)
    if mode == "stream":
        assert count["search.hop.log"] == count["search.rerank"] == 0
    else:
        assert count["search.hop.log"] == count["search.hop"]
        assert count["search.rerank"] == seeds
    # The loop spans of each beam_search, in order: checks and hops.
    loops, cur = [], None
    for s in sorted((s for s in spans if s.parent == root.id),
                    key=lambda s: s.t0):
        if s.name == "search.seed":
            cur = []
            loops.append(cur)
        elif s.name in ("search.check", "search.hop"):
            cur.append(s.name)
    assert len(loops) == seeds
    for names in loops:
        _check_pattern(names)


@pytest.mark.parametrize("max_batch", [1, 64])
def test_one_insert_builds_the_step_tree(max_batch):
    data, _ = _data(n=160)
    coord = Coordinator(_config(), initial_capacity=256, device="cpu")
    coord.bulk_build(range(100), data[:100], max_batch=64)
    coord.max_insert_batch = max_batch
    _traced(lambda: coord.insert(range(100, 160), data[100:]))
    spans = tracing.spans()
    by_id = _assert_nested(spans)
    root = next(s for s in spans if s.parent is None)
    assert root.name == "insert" and root.attrs == {"rows": 60}
    steps = [s for s in spans if s.name == "insert.step"]
    assert all(s.parent == root.id for s in steps)
    assert [s.attrs["rows"] for s in steps] == (
        [1] * 60 if max_batch == 1 else [60])
    for step in steps:
        parts = [s.name for s in spans if s.parent == step.id]
        refresh = ("insert.refresh",) if max_batch == 1 else ()
        assert tuple(parts) == STEP_PARTS + refresh
    for s in spans:
        if s.name.startswith("search."):
            top = s
            while top.name.startswith("search."):
                top = by_id[top.parent]
            assert top.name == "insert.candidates"


def test_candidate_visits_are_the_searchs_own():
    data, _ = _data(seed=0xF00D, n=40)
    coord = Coordinator(_config(), initial_capacity=512, device="cpu")
    base, _ = _data()
    coord.bulk_build(range(N), base, max_batch=64)
    before = coord.snapshot()
    _traced(lambda: coord.insert(range(N, N + 40), data))
    cand = [s for s in tracing.spans() if s.name == "insert.candidates"]
    assert len(cand) == 1 and cand[0].attrs["rows"] == 40
    res = search_for_initial_candidates(
        before.arrays, torch.as_tensor(data), before.entry_slot,
        params=before.params, l_insert=before.config.l_insert,
        beam_width=before.params.insert_beam_width, assume_all_valid=True)
    assert cand[0].attrs["visits"] == int(res.visited_count.sum()) > 0


def _profiled_search(coord, queries, activity):
    from torch.profiler import profile

    with profile(activities=[activity]):
        coord.search(queries, 5)
    inside = len(tracing.spans())
    coord.search(queries, 5)
    return inside, len(tracing.spans())


def test_a_profiler_session_switches_the_recorder_on(built):
    from torch.profiler import ProfilerActivity

    coord, queries = built
    inside, after = _profiled_search(coord, queries, ProfilerActivity.CPU)
    assert inside > 0 and after == inside


@pytest.mark.cuda
def test_a_card_profiler_session_switches_the_recorder_on():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler traces the card")
    from torch.profiler import ProfilerActivity

    data, queries = _data()
    coord = Coordinator(_config(), initial_capacity=N, device="cuda")
    coord.bulk_build(range(N), data, max_batch=64)
    inside, after = _profiled_search(coord, queries, ProfilerActivity.CUDA)
    assert inside > 0 and after == inside


def test_spans_are_read_without_clearing_and_counts_resolved():
    rec = tracing.Recorder("insert", {"rows": 3})
    rec.open("insert.candidates", rows=3)
    rec.close(visits=torch.tensor([1, 2, 4], dtype=torch.int32))
    rec.end()
    first = tracing.spans()
    assert [s.name for s in first] == ["insert", "insert.candidates"]
    assert first[1].attrs == {"rows": 3, "visits": 7}
    assert first[1].parent == first[0].id == first[1].call
    assert tracing.spans() == first
    tracing.clear()
    assert tracing.spans() == []


def test_a_full_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=4))
    for _ in range(2):
        rec = tracing.Recorder("search", {})
        for name in ("search.seed", "search.hop", "search.rerank"):
            rec.open(name)
            rec.close()
        rec.end()
    kept = tracing.spans()
    assert len(kept) == 4 and tracing.dropped() == 4
    assert len({s.call for s in kept}) == 1
    assert kept[0].name == "search" and kept[0].parent is None
    tracing.clear()
    assert tracing.dropped() == 0


def test_a_failed_insert_closes_its_spans(monkeypatch):
    from duckdb_lm_diskann_tpu_torch.core import coordinator as coord_mod

    data, _ = _data(n=40)
    coord = Coordinator(_config(), device="cpu")

    def failing(*args, **kwargs):
        raise RuntimeError("injected")

    coord.insert(range(20), data[:20])
    monkeypatch.setattr(coord_mod, "insert_batch", failing)
    with pytest.raises(RuntimeError, match="injected"):
        _traced(lambda: coord.insert(range(20, 40), data[20:]))
    spans = tracing.spans()
    _assert_nested(spans)
    assert [s.name for s in spans] == ["insert", "insert.step"]


@pytest.mark.parametrize("name", [
    "sift128-int4.search-b1024", "gist960-ternary.search-b256",
    "sift128-int4-ingest.insert-2048",
])
def test_traced_tiny_run_reads_the_span_metrics(name):
    from lmdbench import run
    from lmdbench.tests.tiny import tiny

    bench, cell, config, traffic = tiny(name)
    config["correct"]["recall_at_10"] = {"min": 0.6}
    res = run.run_cell(bench, cell, 2**34 + 3, 0.4, True, device="cpu",
                       config=config, traffic=traffic)
    assert res["correct"] is True, res["checks"]
    metrics = res["metrics"]
    if "insert" in name:
        want = ("candidates_ms_per_step.insert", "update_ms_per_step.insert")
        # No kernel runs on the CPU: the roofline reader finds no time.
        assert "int4_frontier_roofline.insert" not in metrics
    else:
        want = ("merge_ms_per_hop.search", "check_ms_per_hop.search")
    for m in want:
        assert metrics[m]["value"] > 0, m
