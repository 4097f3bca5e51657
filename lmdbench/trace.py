"""Spans, and the reduction of a ``torch.profiler`` trace to numbers.

Every timed call runs inside a harness span (the loop kind's ``span``,
such as ``search.call`` or ``insert.chunk``): a host-clock interval the
harness keeps, so the trace can say what the host was doing while the
card sat idle.

In a ``--trace 1`` run the profiler covers a segment of ``trace_seconds``
that follows the window (a profiler session slows the host's launches for
the rest of the process, so the host-clock spans before it are the
untouched ones). It records the card's activity only (no host operators:
recording those doubles the host's time a hop). The segment opens with a
marker, one small fill issued to an idle card right after a host-clock
reading; the marker's start in the trace ties the trace's clock to the
host's, to within one launch latency. ``summarize`` reduces the trace to:

    busy_s     the union of the card's activity intervals (kernels,
               copies, fills) inside the traced segment
    window_s   the segment's length
    kernel_s   device seconds summed by kernel name
    gaps       the card's idle intervals, each named by the harness span
               open at its middle ("client" when none was)
"""

from __future__ import annotations

import bisect
import time


class Profiled:
    """The traced segment: ``start()``, the calls, then ``stop(spans)``."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.h0 = time.perf_counter()
        if self.cuda:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()

    def stop(self, spans) -> dict:
        """``spans``: (host start, host end, name) of the traced calls."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        h1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        return summarize(self.prof.events(), self.h0, h1, spans)


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, h0: float, h1: float, spans) -> dict:
    """Reduce a profiler's events (microseconds on the trace's clock) to
    the summary above. ``h0`` / ``h1``: the segment's host-clock bounds
    (seconds), ``h0`` taken just before the marker."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    # Trace time of a host reading: shift by the marker's (no card: none).
    shift = dev[0][0] - 1e6 * h0 if dev else -1e6 * h0
    w0, w1 = 1e6 * h0 + shift, 1e6 * h1 + shift
    kernel_s: dict[str, float] = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    named = sorted((1e6 * s0 + shift, 1e6 * s1 + shift, n)
                   for s0, s1, n in spans)
    starts = [s[0] for s in named]
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            mid = 0.5 * (a + t)
            j = bisect.bisect_right(starts, mid) - 1
            name = named[j][2] if j >= 0 and named[j][1] >= mid else "client"
            gaps.append((name, (a - t) * 1e-6))
        t = max(t, b)
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernel_s": kernel_s,
        "gaps": sorted(gaps, key=lambda g: -g[1]),
    }


def breakdown(summary: dict, n: int = 10) -> dict:
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:n]
    return {
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": [[name, s] for name, s in summary["gaps"][:n]],
    }
