"""Finds what ``BENCHMARK.json`` names: a configuration is
``lmdbench/configs/<config>.json`` (its ``file`` entry), a traffic mix is
``lmdbench/traffic/<traffic>.json``, the loop kind that the mix's ``kind``
names is ``lmdbench/loops/<kind>.py``, which defines ``Loop``, and a
per-layer metric is the reader ``lmdbench/metrics/<name>.py``, which
defines ``read(run) -> float | None``. A later cell adds files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def loop(kind: str):
    """The ``Loop`` class of ``loops/<kind>.py``."""
    if not (HERE / "loops" / f"{kind}.py").is_file():
        raise KeyError(f"no loop kind {kind!r} in lmdbench/loops/")
    return importlib.import_module(f"lmdbench.loops.{kind}").Loop


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"lmdbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The cell's end-to-end metrics: those without ``workloads``, and
    those whose ``workloads`` name it."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The cell's per-layer metrics: those whose ``workloads`` name it,
    and those without the key whose ``moves`` the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
