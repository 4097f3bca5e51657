"""Tracing / observability counters.

The port's own copy of ``duckdb_lm_diskann_tpu/utils/tracing.py`` (the port
imports nothing of the JAX package). The reference's tracing story (SURVEY §5): libSQL's compile-time
``DiskAnnTrace`` macro (vectordiskann.c:56-61), ad-hoc std::cout placeholders
in the C++ core (Coordinator.cpp:13-15), and a *planned* EXPLAIN ANALYZE
integration reporting nodes visited / I/Os / distance ops (Consolidated
Proposal:447). Here that plan is implemented: every search records a
:class:`SearchStats`, and :class:`Trace` offers an opt-in structured logger
(off by default, zero overhead when disabled).
"""

from __future__ import annotations

import dataclasses
import logging
import time

logger = logging.getLogger("duckdb_lm_diskann_tpu_torch")


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


class Trace:
    """Opt-in structured tracer (DiskAnnTrace analog, runtime-switchable)."""

    enabled: bool = False

    @classmethod
    def log(cls, event: str, **fields) -> None:
        if cls.enabled:
            logger.info("%s %s", event, fields)


class Timer:
    """Wall-clock scope timer for host-side profiling."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        Trace.log("timer", name=self.name, seconds=self.elapsed)
        return False
