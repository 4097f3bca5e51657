"""Session-level extension settings.

The port's own copy of ``duckdb_lm_diskann_tpu/db/settings.py``.

The reference registers session options with DuckDB's config
(hnsw_index.cpp:655-679): ``hnsw_ef_search`` (overrides the search beam at
scan time, read in InitializeScan :291-299) and
``hnsw_enable_experimental_persistence``. DuckDB options are
per-connection; :class:`Settings` mirrors that — every ``Database`` owns an
instance, so two connections in one process never share overrides. The
module-level functions operate on a process-wide default instance for
standalone (no-Database) use.
"""

from __future__ import annotations

_DEFAULTS: dict[str, object] = {
    # 0 / None -> no override; >0 -> overrides index/config l_search at scan.
    "lm_diskann_l_search": 0,
    "hnsw_ef_search": 0,  # alias kept for drop-in parity
    # Persistence is first-class here (not experimental), but the switch is
    # honored for compatibility: False disables checkpoint-on-commit.
    "lm_diskann_enable_persistence": True,
    # Filtered-search pushdown (V2 design, Consolidated Proposal:419): push
    # residual row predicates into the scan so the top-k is taken over
    # visited-and-allowed rows instead of post-filtering k results. OFF
    # reproduces the reference's pull-up-only behavior (fewer-than-k
    # results under selective filters, hnsw_optimize_scan.cpp:160-200).
    "lm_diskann_filter_pushdown": True,
    # Query-adaptive beam seeding (searcher.pick_adaptive_seeds): >0 seeds
    # each query at its N nearest nodes of a stratified live sample instead
    # of the global entry point — the clustered-corpus entry fix (+2.4%
    # recall@10 on the HARD stressor). 0 (default) keeps the reference's
    # single-global-entry semantics.
    "lm_diskann_adaptive_seeds": 0,
    # Crash-replay backlog bound: when a persisted index's un-merged delta
    # log exceeds this many entries after a DML batch, a checkpoint is
    # triggered inline (docs/DURABILITY.md derives the recovery-time bound
    # this buys: backlog / bulk-insert-rate). 0 disables the trigger.
    "lm_diskann_checkpoint_pending_deltas": 100_000,
}


class Settings:
    """One connection's option set (the per-ClientContext config analog)."""

    def __init__(self) -> None:
        self._values = dict(_DEFAULTS)

    def set_option(self, name: str, value) -> None:
        key = name.strip().lower()
        if key not in self._values:
            raise KeyError(f"Unknown setting '{name}'")
        self._values[key] = value

    def get_option(self, name: str):
        return self._values[name.strip().lower()]

    def effective_l_search(
        self, index_l_search: int, explicit: int | None = None
    ) -> int:
        """Resolution order at scan time (hnsw_index.cpp:291-299 semantics):
        explicit per-query param > session override > index config."""
        if explicit is not None and explicit > 0:
            return explicit
        for key in ("lm_diskann_l_search", "hnsw_ef_search"):
            v = self._values[key]
            if isinstance(v, int) and v > 0:
                return v
        return index_l_search


# Process-wide default instance: used by indexes created outside a Database
# (and by the legacy module-level API).
GLOBAL = Settings()


def set_option(name: str, value) -> None:
    GLOBAL.set_option(name, value)


def get_option(name: str):
    return GLOBAL.get_option(name)


def effective_l_search(index_l_search: int, explicit: int | None = None) -> int:
    return GLOBAL.effective_l_search(index_l_search, explicit)
