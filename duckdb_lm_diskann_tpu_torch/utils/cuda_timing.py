"""Device-side timing on one CUDA card.

CUDA events around a call measure the card's time only when the card is
busy while the host issues the call; the port's loops issue many small
launches, and an idle card then waits for the host between them, so the
events would time the host's launch path. ``device_ms`` queues a sleep
kernel before each timed call, long enough for the host to issue the call
behind it, and checks afterwards that the host did finish first: the
events then time the card's work alone.

``device_ms_train`` issues a train of calls back to back behind one sleep
and times the whole train: each call is charged what a loop of launches
pays for it on the card (its work and the gap between two kernels), not
the fixed cost of events around a lone call.

``wall_ms`` is the same measurement without the sleep: what a caller pays,
host launch path included.
"""

from __future__ import annotations

import time

import torch

_cycles_per_ms: float | None = None


def _events(n):
    return [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]


def hold(ms: float) -> None:
    """Queue a kernel that keeps the current stream busy for ~``ms`` ms."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        torch.cuda._sleep(1000)
        (start, end), = _events(1)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _cycles_per_ms))


def _behind_hold(issue, hold_ms: float, tries: int, what: str) -> float:
    """Card time (ms) of the work ``issue()`` queues, issued behind a sleep
    of ``hold_ms`` and again behind a sleep twice as long until the host
    has issued it all before the sleep ends (RuntimeError after ``tries``:
    the work waits for the card)."""
    h = hold_ms
    for _ in range(tries):
        (sleep_start, sleep_end), (start, end) = _events(2)
        torch.cuda.synchronize()
        sleep_start.record()
        hold(h)
        sleep_end.record()
        t0 = time.perf_counter()
        start.record()
        issue()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms < 0.8 * sleep_start.elapsed_time(sleep_end):
            return start.elapsed_time(end)
        h *= 2
    raise RuntimeError(
        f"{what}: the host took {host_ms:.1f} ms to issue it, longer than a "
        f"{h / 2:.1f} ms hold"
    )


def device_ms(run, n: int, hold_ms: float = 5.0, tries: int = 6) -> list[float]:
    """Card time of each of ``n`` calls ``run(i)``: a list of ms. Each call
    is issued on its own behind a sleep of ``hold_ms`` (the card's launch
    queue holds about a thousand launches, so a long run of calls behind
    one sleep would block the host)."""
    return [
        _behind_hold(lambda i=i: run(i), hold_ms, tries, f"call {i}")
        for i in range(n)
    ]


def device_ms_train(run, n: int, hold_ms: float = 5.0, tries: int = 6) -> float:
    """Card time per call of a train of ``n`` calls ``run(0)`` ...
    ``run(n - 1)`` issued back to back behind one sleep of ``hold_ms``:
    one pair of events around the train, total / n in ms. Keep ``n`` small
    (<= ~50: the launch queue must take the whole train without blocking
    the host)."""
    def train():
        for i in range(n):
            run(i)

    return _behind_hold(train, hold_ms, tries, f"a train of {n} calls") / n


def wall_ms(run, n: int) -> list[float]:
    """Time of each of ``n`` calls ``run(i)`` between CUDA events, each
    issued to an idle card: host launch path included. A list of ms."""
    out = []
    for i in range(n):
        (start, end), = _events(1)
        torch.cuda.synchronize()
        start.record()
        run(i)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out
