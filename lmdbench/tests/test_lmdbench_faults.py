"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have. (The exchange between chips has no
fault to plant: every cell runs on one chip.)"""

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from lmdbench import run
from lmdbench.tests.tiny import tiny


def _run(name):
    bench, cell, config, traffic = tiny(name)
    return run.run_cell(bench, cell, 12345, 0.5, False, device="cpu",
                        config=config, traffic=traffic)


def _failed(res):
    return [n for n, c in res["checks"].items() if not run.judge.holds(c)]


def _alter(ids, n):
    ids = np.array(ids)
    ids[..., 0] = (ids[..., 0] + 1) % n
    return ids


@pytest.mark.parametrize("name", ["sift128-int4.search-b1024",
                                  "gist960-ternary.search-b256",
                                  "sift128-int4-ingest.insert-2048"])
def test_answer_altered_where_it_is_produced(name, monkeypatch):
    search = Coordinator.search

    def altered(self, *a, **k):
        ids, d = search(self, *a, **k)
        return _alter(ids, self.count), d

    monkeypatch.setattr(Coordinator, "search", altered)
    res = _run(name)
    assert res["correct"] is False and "dist_rel_err" in _failed(res)


@pytest.mark.parametrize("name", ["sift128-int4.search-b1024",
                                  "gist960-ternary.search-b256"])
def test_half_of_the_batch_left_out(name, monkeypatch):
    search = Coordinator.search

    def half(self, queries, *a, **k):
        h = len(queries) // 2
        ids, d = search(self, queries[:h], *a, **k)
        return np.concatenate([ids, ids]), np.concatenate([d, d])

    monkeypatch.setattr(Coordinator, "search", half)
    res = _run(name)
    assert res["correct"] is False and "dist_rel_err" in _failed(res)


def test_insert_that_leaves_the_state_unchanged(monkeypatch):
    bench, cell, config, traffic = tiny("sift128-int4-ingest.insert-2048")
    insert = Coordinator.insert

    def unchanged(self, rowids, vectors):
        if self.count < config["rows"]:  # the bulk build itself
            return insert(self, rowids, vectors)

    monkeypatch.setattr(Coordinator, "insert", unchanged)
    res = _run("sift128-int4-ingest.insert-2048")
    assert res["correct"] is False and "unread" in _failed(res)


def test_half_of_each_chunk_left_out(monkeypatch):
    bench, cell, config, traffic = tiny("sift128-int4-ingest.insert-2048")
    insert = Coordinator.insert

    def half(self, rowids, vectors):
        if self.count < config["rows"]:
            return insert(self, rowids, vectors)
        h = len(vectors) // 2
        return insert(self, list(rowids)[:h], vectors[:h])

    monkeypatch.setattr(Coordinator, "insert", half)
    res = _run("sift128-int4-ingest.insert-2048")
    assert res["correct"] is False and "unread" in _failed(res)
