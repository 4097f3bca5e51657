"""Run one benchmark cell once on the card and print its result line.

    python -m lmdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

In order: check the card (none, or fewer than the cell asks for: exit 2,
no result); make the rows and the query pool from ``--seed``
(``corpus.py``); build the index through the program's normal entry; warm
the cell's own call shape; run the closed loop for ``--seconds``; read the
peak device memory; run the program's untimed calls whose answers are
judged too; free the program's state; judge every answer against the plain
reference on the card (``judge.py``); print each compared number beside
its limit on standard error, then one JSON line on standard output.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, read by ``metrics/<name>.py`` from the harness's spans,
the program's ``SearchStats`` and a ``torch.profiler`` trace of a segment
of ``trace_seconds`` that follows the window (``trace.py``), with the
card's busy and traced seconds and a ``breakdown``.

The kernels' nvcc builds stay in the program's own ``_build/`` directory
inside the checkout, so only a checkout's first run builds them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402


from . import corpus, judge, registry, trace  # noqa: E402

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "duckdb_lm_diskann_tpu", "bench",
             "benchmarks", "chip_smoke")


def forbidden_modules() -> list[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def _power_limit_w(index: int) -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def _calls(loop, records, seconds: float, traced: bool) -> float:
    """Calls until ``seconds`` have passed; returns the start time."""
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        loop.prepare(len(records))
        t0 = time.perf_counter()
        rec = loop.call(len(records))
        t1 = time.perf_counter()
        rec.update(span=loop.span, t0=t0, t1=t1, traced=traced)
        records.append(rec)
    return start


def window(loop, seconds: float, traced: bool, trace_seconds: float):
    """The closed loop for ``seconds``; in a traced run, then a segment of
    ``trace_seconds`` more under the profiler. Returns (records, start,
    elapsed seconds of the untraced window, trace summary or None)."""
    records = []
    start = _calls(loop, records, seconds, False)
    elapsed = records[-1]["t1"] - start
    summary = None
    if traced:
        prof = trace.Profiled()
        prof.start()
        _calls(loop, records, trace_seconds, True)
        summary = prof.stop([(r["t0"], r["t1"], r["span"])
                             for r in records if r["traced"]])
    return records, start, elapsed, summary


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: str = "cuda", config: dict | None = None,
             traffic: dict | None = None, t0: float = T0) -> dict:
    """One run of ``cell``; returns the result object. ``config`` and
    ``traffic`` replace the registry's files (the CPU tests' small sizes);
    ``device`` "cpu" drives the program's CPU path (tests only)."""
    import torch

    config = config or registry.config(bench, cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    inputs = corpus.make_inputs(config, traffic, seed)
    loop_seed, = corpus.run_seed(seed).spawn(2)[1:]
    kind = registry.loop(traffic["kind"])
    loop = kind(config, traffic, inputs, loop_seed, device)
    loop.setup()
    for i in range(traffic["warm_calls"]):
        loop.prepare(-1 - i)
        loop.call(-1 - i)
    records, start, elapsed, summary = window(
        loop, seconds, traced, traffic.get("trace_seconds", 0))
    loop.finish()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    pool, readback = loop.answers()
    rows = loop.live_rows()
    loop.free()
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge.judge(config, rows, pool, readback, device)
    checks = judge.checks(config, numbers)
    correct = all(judge.holds(c) for c in checks.values())

    timed = [r for r in records if not r["traced"]]
    values = {
        "setup_s": start - t0,
        "recall_at_10": numbers["recall_at_10"],
        kind.rate: sum(r["n"] for r in timed) / elapsed,
    }
    name = torch.cuda.get_device_name() if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell["chips"], "memory_peak_bytes": int(peak),
           "power_limit_w": _power_limit_w(0) if on_card else None}
    metrics = {}
    result = {"correct": correct, "attempted": sum(r["n"] for r in records),
              "failed": numbers["missing"] + numbers.get("unread", 0)}
    if not traced:
        for m in registry.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = types.SimpleNamespace(
            calls=records, trace=summary, config=config, traffic=traffic,
            device_name=name)
        for m in registry.per_layer(bench, cell["name"]):
            v = registry.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
    result["metrics"] = metrics
    result["device"] = dev
    if traced and summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"lmdbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"lmdbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['op']} {c['limit']!r} "
              f"{'ok' if judge.holds(c) else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
