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

``slope_ms`` times a loop of steps both ways, as the slope of wall time
against the step count and as the card's time of the steps issued in
chunks behind sleeps (the hop profilers' method). ``kernel_ms`` is for a
call that waits on the card itself (a search reading its loop condition),
which a sleep in front would only stall: the card's busy time during the
call in a ``torch.profiler`` trace.
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


def host_clock_ms(run) -> float:
    """Host-clock ms of ``run()``: the CPU's stand-in for ``wall_ms``."""
    t0 = time.perf_counter()
    run()
    return 1e3 * (time.perf_counter() - t0)


def slope_ms(step, states, iters_lo, iters_hi, reps=4, chunk=8):
    """(wall, card) ms per iteration of ``step(state, i) -> state``, best
    of ``reps``; each run starts from a clone of one of ``states`` (tuples
    of tensors).

    wall: the slope between ``iters_lo`` and ``iters_hi`` iterations issued
    to an idle card (after a warm-up of each), so fixed per-run costs
    cancel; the host launch path is included. card: ``iters_lo``
    iterations issued in chunks of ``chunk``, each behind a sleep kernel
    (``device_ms``), so the events time the card's work alone; their sum
    over the iterations. On CPU tensors wall is the host clock's slope and
    card is None: there is no card to time."""
    on_card = states[0][0].is_cuda

    def wall(iters, state):
        state = tuple(t.clone() for t in state)

        def loop(_):
            s = state
            for i in range(iters):
                s = step(s, i)

        return wall_ms(loop, 1)[0] if on_card else host_clock_ms(lambda: loop(0))

    def card(state, hold_ms):
        box = [tuple(t.clone() for t in state)]

        def run(c):
            s = box[0]
            for i in range(c * chunk, (c + 1) * chunk):
                s = step(s, i)
            box[0] = s

        times = device_ms(run, iters_lo // chunk, hold_ms=hold_ms)
        return sum(times) / iters_lo

    wall(iters_lo, states[0])
    hold_ms = 1.5 * chunk * wall(iters_hi, states[0]) / iters_hi
    t_lo, t_hi, t_card = [], [], []
    for i in range(reps):
        s = states[(i + 1) % len(states)]
        t_lo.append(wall(iters_lo, s))
        t_hi.append(wall(iters_hi, s))
        if on_card:
            t_card.append(card(s, hold_ms))
    slope = (min(t_hi) - min(t_lo)) / (iters_hi - iters_lo)
    return slope, (min(t_card) if on_card else None)


def kernel_ms(run) -> float | None:
    """The card's busy time (ms) while ``run()`` executes: the union of the
    device activity intervals (kernels, copies, fills) that a
    ``torch.profiler`` trace of the call records. None when the trace
    holds no device activity (the profiler could not trace the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3
