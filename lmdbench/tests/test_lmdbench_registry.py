"""BENCHMARK.json against the files the harness finds by name, and the
contract's shape rules."""

import json
import re

import pytest

from lmdbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
        assert all(NAME.match(n) for n in names), names


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        cfg = registry.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["correct"]) >= {"missing", "dist_rel_err",
                                       "recall_at_10"}
    for w in BENCH["workloads"]:
        kind = registry.loop(registry.traffic(w["traffic"])["kind"])
        assert kind.span and kind.rate
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in registry.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.per_layer(BENCH, cell)
    assert layer
    assert all(m["moves"] in e2e for m in layer)


def test_metrics_entries():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_loop_kinds_are_found_by_file():
    assert registry.loop("search").span == "search.call"
    assert registry.loop("insert").rate == "insert_rows_per_s"
    with pytest.raises(KeyError):
        registry.loop("no_such_kind")
