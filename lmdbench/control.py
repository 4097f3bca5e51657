"""The control: the reference put in the program's place, in TF32.

    python -m lmdbench.control --workload <name> --seeds <n> [<n> ...]

For each seed it makes the run's inputs, answers them with
``reference.control_topk`` (the brute force computed in TF32, the nearest
precision below the configuration's float32) where the program would, and
judges those answers with the run's own comparison (``judge.py``). A write
mix's control holds the base rows plus the first ``stream_rows`` stream
rows, reads back as many sampled rows as a run does and answers the pool
on all of them. Prints one JSON line a seed; every one must come out not
correct. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import corpus, judge, reference, registry


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    inputs = corpus.make_inputs(config, traffic, seed)
    k, metric = config["k"], config["metric"]
    readback = None
    rows = inputs.base
    if traffic["kind"] == "insert":
        n_ins = traffic["stream_rows"]
        rows = inputs.rows(len(inputs.base) + n_ins)
        _, loop_seed = corpus.run_seed(seed).spawn(2)
        own = np.sort(np.random.default_rng(loop_seed).choice(
            np.arange(len(inputs.base), len(rows)),
            min(traffic["readback"], n_ins), replace=False))
        ids, d = reference.control_topk(rows, rows[own], k, metric, device)
        readback = judge.Answers(rows[own], np.arange(len(own)), ids, d, own)
    ids, d = reference.control_topk(rows, inputs.pool, k, metric, device)
    pool = judge.Answers(inputs.pool, np.arange(len(inputs.pool)), ids, d)
    return judge.judge(config, rows, pool, readback, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    config = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for seed in args.seeds:
        numbers = control_numbers(config, traffic, seed, "cuda")
        checks = judge.checks(config, numbers)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": all(judge.holds(c) for c in checks.values()),
            "checks": checks,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
