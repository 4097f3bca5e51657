"""Each traffic kind's loop at a small size on the program's CPU path, the
result line's schema, the import guard and the refusal without a card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from lmdbench import registry, run
from lmdbench.tests.tiny import CELLS, tiny

ROOT = Path(__file__).resolve().parents[2]


def _run(name, traced, seconds=0.6):
    bench, cell, config, traffic = tiny(name)
    # At these sizes the graph reaches a lower recall than at the cells'.
    config["correct"]["recall_at_10"] = {"min": 0.6}
    return run.run_cell(bench, cell, 2**33 + 5, seconds, traced,
                        device="cpu", config=config, traffic=traffic)


@pytest.mark.parametrize("name", CELLS)
def test_loop_runs_and_is_correct(name):
    res = _run(name, traced=False)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = registry.benchmark()
    want = {m["name"] for m in registry.end_to_end(bench, name)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_layers_and_breakdown(name):
    res = _run(name, traced=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    bench = registry.benchmark()
    allowed = {m["name"] for m in registry.per_layer(bench, name)}
    assert set(res["metrics"]) <= allowed
    # Host-clock and span readers find something on the CPU too; the
    # kernels' rooflines find no kernel there and stay silent.
    assert not any(k.endswith("_roofline") for k in res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_search_options_of_the_mix_reach_the_search():
    bench, cell, config, traffic = tiny("gist960-ternary.search-b256")
    config["correct"]["recall_at_10"] = {"min": 0.6}
    traffic["search_options"] = {"stream": True, "lanes": 16}
    res = run.run_cell(bench, cell, 7, 0.6, False, device="cpu",
                       config=config, traffic=traffic)
    assert res["correct"] is True, res["checks"]


class _SlowPrepare:
    span = "x.call"

    def prepare(self, i):
        time.sleep(0.05)

    def call(self, i):
        return {"n": 1}


def test_prepare_lies_outside_the_timed_span():
    records, start, elapsed, _ = run.window(_SlowPrepare(), 0.3, False, 0)
    assert len(records) >= 3
    assert all(r["t1"] - r["t0"] < 0.02 for r in records)
    assert elapsed >= 0.05 * len(records)


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    code = (
        "import torch; torch.set_num_threads(1)\n"
        "from lmdbench import run, control, registry\n"
        "from lmdbench.tests.tiny import tiny\n"
        "b, c, cfg, tr = tiny('gist960-ternary.search-b256')\n"
        "run.run_cell(b, c, 1, 0.3, True, device='cpu', config=cfg,"
        " traffic=tr)\n"
        "[registry.reader(m['name']) for m in b['per_layer']]\n"
        "print(run.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    out = _python("import sys, lmdbench.reference\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}"
                  " & {'duckdb_lm_diskann_tpu_torch', 'duckdb_lm_diskann_tpu',"
                  " 'jax'}))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_free_helper", object())
    monkeypatch.setitem(sys.modules, "duckdb_lm_diskann_tpu_torch.x",
                        object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "duckdb_lm_diskann_tpu.core", object())
    assert run.forbidden_modules() == ["duckdb_lm_diskann_tpu"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "lmdbench.run", "--workload",
         "gist960-ternary.search-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
