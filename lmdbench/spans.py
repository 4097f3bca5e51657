"""Shared arithmetic of the readers of the program's own spans
(``duckdb_lm_diskann_tpu_torch.utils.tracing``).

The program records its spans while a profiler session is on, on the host
clock that the harness's spans use, so a ``--trace 1`` run's traced
segment carries them. A reader takes the spans of the program's public
calls whose root span lies inside a traced harness call (``run.calls``
with ``traced`` true, by ``t0`` / ``t1``), and returns None when there are
none: a program without the recorder (no ``tracing.spans``) gives none.
"""

from __future__ import annotations


def traced(run, root: str) -> list:
    """The spans of the program's ``root`` calls inside the traced harness
    calls; empty where there are none."""
    try:
        from duckdb_lm_diskann_tpu_torch.utils import tracing
    except ImportError:
        return []
    read = getattr(tracing, "spans", None)
    if read is None:
        return []
    windows = [(c["t0"], c["t1"]) for c in run.calls if c["traced"]]
    spans = read()
    keep = {s.call for s in spans
            if s.parent is None and s.name == root
            and any(a <= s.t0 and s.t1 <= b for a, b in windows)}
    return [s for s in spans if s.call in keep]


def _seconds(spans) -> float:
    return sum(s.t1 - s.t0 for s in spans)


def per_hop_ms(run, name: str) -> float | None:
    """The summed ``name`` spans of the traced ``search`` calls over their
    count of ``search.hop`` spans, in ms."""
    spans = traced(run, "search")
    hops = sum(1 for s in spans if s.name == "search.hop")
    if not hops:
        return None
    return 1e3 * _seconds(s for s in spans if s.name == name) / hops


def per_step_ms(run) -> dict | None:
    """Of the traced ``insert`` calls' ``insert.step`` spans, in ms a step:
    ``candidates``, their ``insert.candidates`` children, and ``update``,
    the steps less their ``insert.store`` and ``insert.candidates``
    children (prune, write, reciprocal, force and refresh together)."""
    spans = traced(run, "insert")
    steps = {s.id for s in spans if s.name == "insert.step"}
    if not steps:
        return None

    def child(name):
        return _seconds(s for s in spans
                        if s.name == name and s.parent in steps)

    total = _seconds(s for s in spans if s.id in steps)
    cand = child("insert.candidates")
    return {"candidates": 1e3 * cand / len(steps),
            "update": 1e3 * (total - cand - child("insert.store"))
            / len(steps)}


def candidate_search(run) -> dict | None:
    """The traced ``insert`` calls' candidate searches as one harness call
    record: ``visits`` and ``n`` (rows searched) summed over their
    ``insert.candidates`` spans, under the span name ``insert.candidates``,
    for ``readers.kernel_roofline``."""
    spans = [s for s in traced(run, "insert")
             if s.name == "insert.candidates"]
    if not spans:
        return None
    return {"span": "insert.candidates", "traced": True,
            "visits": sum(s.attrs["visits"] for s in spans),
            "n": sum(s.attrs["rows"] for s in spans)}
