"""Search counters and the span recorder.

Every ``Coordinator.search`` records a :class:`SearchStats`, the EXPLAIN
ANALYZE payload (the info pragma prints its ``explain()``).

The span recorder times the parts of a public call on the host clock
(``time.perf_counter``). A span is a name, its host start and end, its
parent span, the id of the public call that caused it (every span of one
``Coordinator.search`` or ``Coordinator.insert`` shares it) and optional
counts (``attrs``). A count that lives on the card is kept as a tensor and
resolved, as the sum of its elements, only when the spans are read.

It records while a ``torch.profiler`` session is active, so every profile
of the card comes with the program's spans on the host clock, or after
:func:`enable`. The decision is made once per public call:
:func:`recorder` returns a :class:`Recorder` or None, and the layers below
take that and test it for None at each span site. Off, a site costs that
test alone: no clock reading, no allocation, no launch.

No span synchronises the card. A span's length is what the host spent in
that part of the call: its launches, plus any wait at a blocking read
inside it (``search.check``, ``search.readback``). Device work that a part
queues and a later blocking read drains is counted in the later span.

Spans stay in memory, in a buffer of the newest ``CAPACITY`` spans; older
ones are dropped and counted (:func:`dropped`). :func:`spans` reads them
without clearing; :func:`clear` empties the buffer. A call's spans reach
the buffer when the call returns.

The span names and what they cover:

  search              ``Coordinator.search``, entry to return (queries,
                      l_search, k)
  search.seed         query planes, seed distances, the padded beam and
                      the loop's buffers
  search.check        the blocking read of the loop condition, every
                      ``_CHECK_EVERY``-th iteration
  search.hop          one iteration of the search loop after its check
  search.hop.visit    the visited node's exact distance and visit flags
  search.hop.score    the neighbors' gather, validity and frontier scores
  search.hop.merge    the skip masks and the merge into the beam
  search.hop.log      the visited-log append (``beam_search``)
  search.rerank       the final top-k over the visited log
  search.readback     the results' copies to the host
  insert              ``Coordinator.insert`` (rows)
  insert.step         one batch of the insert (rows)
  insert.store        ``store_vectors``
  insert.candidates   the candidate search, ``search.*`` spans inside it
                      (rows, visits)
  insert.prune        ``batched_robust_prune``
  insert.write        ``write_neighbor_rows``
  insert.reciprocal   the reciprocal pairs and rounds
  insert.force        the in-link guarantee rounds
  insert.refresh      edge-code refresh of a sequential insert
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

import torch

# Spans the buffer keeps.
CAPACITY = 1 << 18

_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_enabled = False
_ids = itertools.count(1)


@dataclasses.dataclass
class SearchStats:
    """Per-search-call counters — the EXPLAIN ANALYZE payload the design
    doc promises (nodes visited / I/Os / distance ops / timing,
    Consolidated Proposal:447)."""

    queries: int = 0
    hops: int = 0  # lock-step loop iterations for the batch
    nodes_visited: int = 0  # total across the batch ("I/Os": one gather each)
    l_search: int = 0
    k: int = 0
    # Distance computations: every visit scores its R cached edge codes +
    # one exact distance to the visited node's full vector; every query
    # scores the seed set exactly (vectordiskann.c:1306-1322,1366-1396).
    distance_ops: int = 0
    wall_time_s: float = 0.0  # host wall clock incl. device round-trip

    @property
    def mean_visits_per_query(self) -> float:
        return self.nodes_visited / max(self.queries, 1)

    @property
    def latency_ms_per_query(self) -> float:
        return self.wall_time_s * 1e3 / max(self.queries, 1)

    def explain(self) -> str:
        """Human-readable EXPLAIN ANALYZE-style report."""
        return (
            f"beam_search: queries={self.queries} k={self.k} "
            f"l_search={self.l_search} hops={self.hops} "
            f"nodes_visited={self.nodes_visited} "
            f"(mean {self.mean_visits_per_query:.1f}/query; one block gather "
            f"per visited node) distance_ops={self.distance_ops} "
            f"time={self.wall_time_s*1e3:.2f}ms "
            f"({self.latency_ms_per_query:.3f}ms/query)"
        )


class Span(NamedTuple):
    id: int
    parent: int | None  # None for the root: the public call itself
    call: int  # the id of the call's root span
    name: str
    t0: float  # time.perf_counter() at the start
    t1: float  # and at the end
    attrs: dict


class Recorder:
    """The open spans of one public call, a stack: ``open`` pushes a child
    of the innermost open span, ``close`` ends it, ``switch`` ends it and
    opens its next sibling at the same clock reading. ``end`` closes every
    span still open and hands the call's spans to the buffer."""

    __slots__ = ("call", "_stack", "_done", "_closed")

    def __init__(self, name: str, attrs: dict):
        self.call = next(_ids)
        self._stack = [[self.call, name, time.perf_counter(), attrs or None]]
        self._done: collections.deque = collections.deque(maxlen=CAPACITY)
        self._closed = 0

    def open(self, name: str, **attrs) -> None:
        self._stack.append(
            [next(_ids), name, time.perf_counter(), attrs or None])

    def set(self, **attrs) -> None:
        """Add counts to the innermost open span."""
        top = self._stack[-1]
        top[3] = {**(top[3] or {}), **attrs}

    def close(self, **attrs) -> None:
        """End the innermost open span, adding ``attrs`` to its counts."""
        self._close(time.perf_counter(), attrs)

    def switch(self, name: str, **attrs) -> None:
        t = time.perf_counter()
        self._close(t, None)
        self._stack.append([next(_ids), name, t, attrs or None])

    def _close(self, t1: float, attrs: dict | None) -> None:
        sid, name, t0, own = self._stack.pop()
        if attrs:
            own = {**(own or {}), **attrs}
        parent = self._stack[-1][0] if self._stack else None
        self._closed += 1
        self._done.append((sid, parent, self.call, name, t0, t1, own))

    def end(self) -> None:
        global _dropped
        t1 = time.perf_counter()
        while self._stack:
            self._close(t1, None)
        with _lock:
            _dropped += self._closed - len(self._done) + max(
                0, len(_buffer) + len(self._done) - CAPACITY)
            _buffer.extend(self._done)
        self._done.clear()
        self._closed = 0


def recorder(name: str, **attrs) -> Recorder | None:
    """The recorder of a public call named ``name``, its root span open, or
    None when neither a profiler session nor :func:`enable` is on."""
    if not (_enabled or torch.autograd._profiler_enabled()):
        return None
    return Recorder(name, attrs)


def end(rec: Recorder | None) -> None:
    """``rec.end()`` where there is a recorder."""
    if rec is not None:
        rec.end()


def enable() -> None:
    """Record every public call, with or without a profiler session."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only inside profiler sessions (the default)."""
    global _enabled
    _enabled = False


def spans() -> list[Span]:
    """The buffer's spans of finished calls, in start order, their device
    counts resolved to Python numbers. The buffer is left as it is."""
    with _lock:
        out = sorted((Span(*s[:6], s[6] or {}) for s in _buffer),
                     key=lambda s: s.t0)
    for s in out:
        for key, v in s.attrs.items():
            if isinstance(v, torch.Tensor):
                s.attrs[key] = v.sum().item()
    return out


def dropped() -> int:
    """Spans dropped from the buffer since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0
