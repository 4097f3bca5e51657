"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

A reader gets the run: ``calls`` (one record per timed call: ``span``,
host-clock ``t0`` / ``t1``, ``n``, the program's ``SearchStats`` numbers
``hops`` / ``visits`` / ``search_s`` where the call searched, and
``traced``), ``trace`` (``trace.summarize``'s summary, or None),
``config``, ``traffic`` and ``device_name``. Host-clock readings use the
calls made before the profiler started; trace readings use the traced
calls. A reader with nothing to read returns None.
"""

from __future__ import annotations

import numpy as np

from . import roofline


def _calls(run, span, traced):
    return [c for c in run.calls
            if c["span"] == span and c["traced"] == traced]


def ms_per_hop(run, span):
    """The calls' summed ``SearchStats.wall_time_s`` over their summed
    hops, in ms."""
    calls = [c for c in _calls(run, span, False) if "hops" in c]
    hops = sum(c["hops"] for c in calls)
    if not hops:
        return None
    return 1e3 * sum(c["search_s"] for c in calls) / hops


def p95_ms(run, span):
    calls = _calls(run, span, False)
    if not calls:
        return None
    return float(np.percentile([1e3 * (c["t1"] - c["t0"]) for c in calls], 95))


def idle_share(run):
    """The card's idle share of the traced segment, in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_roofline(run, kernel, span, bytes_fn):
    """The least time the card needs for the traced calls' visits (bytes
    over the HBM bandwidth) over the device time of kernels whose name
    holds ``kernel``, in %."""
    if run.trace is None:
        return None
    t = sum(s for name, s in run.trace["kernel_s"].items() if kernel in name)
    bw = roofline.hbm_bytes_per_s(run.device_name)
    calls = [c for c in _calls(run, span, True) if "visits" in c]
    if t <= 0 or bw is None or not calls:
        return None
    need = bytes_fn(sum(c["visits"] for c in calls),
                    sum(c["n"] for c in calls),
                    run.config["r"], run.config["dims"])
    return 100.0 * need / bw / t
