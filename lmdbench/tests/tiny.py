"""Small sizes of the benchmark's cells for the CPU tests: the cells'
own files with the rows, widths and graph options cut so that a run takes
seconds on the program's CPU path."""

from __future__ import annotations

import torch

from lmdbench import registry

CELLS = ("sift128-int4.search-b1024", "gist960-ternary.search-b256",
         "sift128-int4-ingest.insert-2048")


def tiny(name: str, rows: int = 1500, dims: int = 32):
    """(bench, cell, config, traffic) of ``name`` at a small size."""
    torch.set_num_threads(1)
    bench = registry.benchmark()
    cell = registry.workload(bench, name)
    config = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    config.update(rows=rows, dims=dims, r=16, l_insert=32, l_search=48)
    traffic.update(pool=96, warm_calls=1, trace_seconds=0.3)
    if "batch" in traffic:
        traffic["batch"] = 32
    if traffic["kind"] == "insert":
        traffic.update(capacity=4096, stream_rows=512,
                       chunk=128, readback=64)
    return bench, cell, config, traffic
