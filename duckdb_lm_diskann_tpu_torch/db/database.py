"""Database / Table surface: catalog, DML hooks, pragmas, and macros.

The top of the stack — the analog of the reference's extension registration
(``lm_diskann_init`` / ``LmDiskannExtension::Load``,
src/lm_diskann_extension.cpp:15-36, which registers the L5 modules) plus the
catalog/table plumbing DuckDB provides. A :class:`Database` owns tables and
their vector indexes; DML on a table flows through the index hooks exactly
like DuckDB's BoundIndex callbacks (Append/Insert/Delete/Vacuum/CommitDrop).

Also provides:
  - ``pragma_lm_diskann_index_info()`` — the pragma_hnsw_index_info table
    function (hnsw_index_pragmas.cpp:22-61,195-202)
  - ``lm_diskann_compact_index`` — the compaction pragma (:154-190)
  - ``lm_diskann_match`` / ``lm_diskann_join`` — the brute-force table
    macros (hnsw_index_macros.cpp:10-113)
  - ``knn`` / ``knn_join`` — the optimized query entry points that build a
    logical plan, run the optimizer rewrites, and execute.

Counterpart of ``duckdb_lm_diskann_tpu/db/database.py``. A Database lives on
one device (``connect(path, device="cuda")``, the card unless the caller
asks for the CPU): its indexes keep their graphs there and its brute-force
scans run there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common.types import MetricType
from . import planner, settings
from .functions import ColumnRef, Const, FunctionExpr, evaluate_distance
from .index import LmDiskannIndex


class Table:
    """A columnar table with int64 row ids (DataChunk-of-arrays analog).

    Row ids only grow (an insert takes ids past every earlier one, a delete
    keeps the order), so ``row_ids`` stays sorted and ``fetch`` finds rows
    by binary search. ``device`` is where scans of the table compute."""

    def __init__(self, name: str, columns: dict[str, np.ndarray], device="cuda"):
        self.name = name
        self.device = device
        sizes = {len(v) for v in columns.values()}
        if len(sizes) > 1:
            raise ValueError("column length mismatch")
        n = sizes.pop() if sizes else 0
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self.row_ids = np.arange(n, dtype=np.int64)
        self._next_rowid = n
        self.indexes: dict[str, "BoundTableIndex"] = {}

    @property
    def count(self) -> int:
        return len(self.row_ids)

    def fetch(self, rowids, column: str) -> np.ndarray:
        rowids = np.asarray(rowids, np.int64).reshape(-1)
        pos = np.searchsorted(self.row_ids, rowids)
        found = pos < len(self.row_ids)
        found[found] = self.row_ids[pos[found]] == rowids[found]
        if not found.all():
            raise KeyError(int(rowids[~found][0]))
        return self.columns[column][pos]

    # --- DML with index maintenance (the BoundIndex hook wiring) ---

    def insert(self, values: dict[str, np.ndarray]) -> np.ndarray:
        lengths = {len(v) for v in values.values()}
        n = lengths.pop()
        new_ids = np.arange(self._next_rowid, self._next_rowid + n, dtype=np.int64)
        self._next_rowid += n
        for k in self.columns:
            self.columns[k] = np.concatenate([self.columns[k], np.asarray(values[k])])
        self.row_ids = np.concatenate([self.row_ids, new_ids])
        for bidx in self.indexes.values():
            bidx.index.insert(new_ids.tolist(), np.asarray(values[bidx.column]))
        return new_ids

    def delete(self, rowids) -> None:
        keep = ~np.isin(self.row_ids, rowids)
        for k in self.columns:
            self.columns[k] = self.columns[k][keep]
        self.row_ids = self.row_ids[keep]
        for bidx in self.indexes.values():
            bidx.index.delete(list(rowids))


@dataclasses.dataclass
class BoundTableIndex:
    column: str
    index: LmDiskannIndex


class Database:
    """Catalog of tables + the registered lm_diskann extension surface."""

    def __init__(self, path: str | None = None, device="cuda"):
        self.path = path  # None -> in-memory (no persistence dirs)
        self.device = device
        self.tables: dict[str, Table] = {}
        # Per-connection session options (hnsw_index.cpp:655-679 registers
        # these with DuckDB's per-ClientContext config; two Databases in one
        # process must not share overrides).
        self.settings = settings.Settings()

    def set_option(self, name: str, value) -> None:
        """SET <option> = <value> (session scope)."""
        self.settings.set_option(name, value)

    def get_option(self, name: str):
        return self.settings.get_option(name)

    # --- catalog ---

    def create_table(self, name: str, columns: dict[str, np.ndarray]) -> Table:
        if name in self.tables:
            raise KeyError(f"table {name} exists")
        t = Table(name, columns, device=self.device)
        self.tables[name] = t
        return t

    def create_index(
        self,
        index_name: str,
        table: "str | Table",
        column: str,
        options: dict | None = None,
    ) -> LmDiskannIndex:
        """CREATE INDEX ... USING LM_DISKANN(col) WITH (...) — validates
        options, derives dims/dtype from the column, bulk-builds from
        existing rows (HNSWIndex::CreatePlan + PhysicalCreateHNSWIndex
        semantics, hnsw_index_plan.cpp:17-160)."""
        t = self.tables[table] if isinstance(table, str) else table
        data = t.columns[column]
        if data.ndim != 2:
            raise TypeError("index column must be a fixed-size ARRAY column")
        idx = LmDiskannIndex(
            index_name,
            data.dtype,
            data.shape[1],
            options=options,
            db_path=self.path,
            session=self.settings,
            device=self.device,
        )
        # IS NOT NULL filter of the create plan: rows with NaNs are skipped
        # (the reference's projection + null filter, hnsw_index_plan.cpp).
        finite = (
            np.isfinite(data).all(axis=1)
            if np.issubdtype(data.dtype, np.floating)
            else np.ones(len(data), bool)
        )
        want_rowids = t.row_ids[finite]
        if idx.coordinator.count:
            # A persisted index was auto-loaded from a prior session. Reuse
            # it when it indexes exactly the table's rows (the natural
            # reopen workflow); otherwise rebuild from scratch — re-running
            # bulk_build into the loaded coordinator would raise on
            # duplicate row ids. Matching rowids alone is not sufficient:
            # a table recreated with the same ids but different VECTORS
            # must not silently reuse the stale graph, so a sample of rows
            # is value-checked against the index's stored vectors.
            have = set(idx.coordinator.allocator.rowid_to_slot)

            def content_matches() -> bool:
                if not len(want_rowids):
                    return True
                vectors = idx.coordinator.arrays.vectors
                slots = idx.coordinator.allocator.lookup_slots(want_rowids)
                stored = (
                    vectors[torch.as_tensor(slots, device=vectors.device).long()]
                    .cpu()
                    .numpy()
                    .astype(np.float32)
                )
                table_rows = data[finite].astype(np.float32)
                if vectors.dtype == torch.int8:
                    table_rows = np.clip(np.round(table_rows), -128, 127)
                return np.allclose(stored, table_rows, atol=1e-6)

            if have != {int(r) for r in want_rowids} or not content_matches():
                idx.coordinator.handle_commit_drop()
                if idx.coordinator.shadow_service is not None:
                    idx.coordinator.shadow_service.reset()
                if finite.any():
                    idx.coordinator.bulk_build(
                        want_rowids.tolist(), data[finite].astype(np.float32)
                    )
        elif finite.any():
            idx.coordinator.bulk_build(
                want_rowids.tolist(), data[finite].astype(np.float32)
            )
        t.indexes[index_name] = BoundTableIndex(column, idx)
        return idx

    def drop_index(self, table: "str | Table", index_name: str) -> None:
        t = self.tables[table] if isinstance(table, str) else table
        bidx = t.indexes.pop(index_name)
        bidx.index.commit_drop()

    # --- query surface ---

    def knn(
        self,
        table: "str | Table",
        column: str,
        query: np.ndarray,
        k: int,
        metric: "str | MetricType" = MetricType.L2,
        filter=None,
        return_plan: bool = False,
    ):
        """SELECT * FROM t ORDER BY dist(col, q) LIMIT k — builds the TopN
        plan, runs the optimizer (index rewrite if a matching index exists),
        executes."""
        t = self.tables[table] if isinstance(table, str) else table
        metric = MetricType.parse(metric)
        fn_name = {
            MetricType.L2: "array_distance",
            MetricType.COSINE: "array_cosine_distance",
            MetricType.IP: "array_negative_inner_product",
        }[metric]
        expr = FunctionExpr(
            fn_name, (ColumnRef(column), Const(np.asarray(query, np.float32)))
        )
        plan = planner.LogicalTopN(
            planner.LogicalGet(t, filter=filter), expr, k
        )
        optimized = planner.optimize(plan)
        result = planner.execute(optimized)
        result.pop("_table", None)
        if return_plan:
            return result, optimized
        return result

    def knn_join(
        self,
        left_table: "str | Table",
        left_column: str,
        right_queries: np.ndarray,
        k: int,
        return_plan: bool = False,
    ):
        """Lateral top-k join: for each RHS query vector, the k nearest LHS
        rows with 1-indexed rank.

        Builds the *unoptimized* correlated lateral plan — the
        filter(row_number <= k) -> window -> cross_product shape a SQL
        frontend would produce — and lets the join optimizer rewrite it into
        LogicalKnnJoin, one batched MultiScan (hnsw_optimize_join.cpp:352-480
        matcher + :33-181 physical operator). Without a matching index the
        lateral plan executes as-is (brute force)."""
        t = self.tables[left_table] if isinstance(left_table, str) else left_table
        queries = np.atleast_2d(np.asarray(right_queries, np.float32))
        metric = index_metric_or_default(t, left_column)
        fn_name = {
            MetricType.L2: "array_distance",
            MetricType.COSINE: "array_cosine_distance",
            MetricType.IP: "array_negative_inner_product",
        }[metric]
        qt = Table("__knn_join_queries__", {"q": queries}, device=t.device)
        dist_expr = FunctionExpr(
            fn_name,
            (ColumnRef("q", table=qt.name), ColumnRef(left_column, table=t.name)),
        )
        plan = planner.LogicalExprFilter(
            planner.LogicalWindow(
                planner.LogicalCrossProduct(
                    planner.LogicalGet(qt), planner.LogicalGet(t)
                ),
                function="row_number",
                partition="__left_row__",
                order_expr=dist_expr,
            ),
            FunctionExpr("<=", (ColumnRef("row_number"), Const(k))),
        )
        optimized = planner.optimize(plan)
        res = planner.execute(optimized)
        res.pop("_table", None)
        if "rank" not in res:
            # Unoptimized lateral execution: normalize to the KnnJoin output
            # shape (rows ordered by (query, rank), 1-indexed 'rank').
            order = np.lexsort((res["row_number"], res["query_index"]))
            res = {key: val[order] for key, val in res.items()}
            res["rank"] = res.pop("row_number")
        if return_plan:
            return res, optimized
        return res

    def vector_top_k(self, index_name: str, query, k: int) -> dict:
        """libSQL's ``vector_top_k(idx_name, vector, k)`` virtual table
        (vectorIndexInt.h:228-236): top-k row ids by the INDEX's own
        metric, addressed by index name rather than table/column."""
        matches = [
            (t, bidx)
            for t in self.tables.values()
            for name, bidx in t.indexes.items()
            if name == index_name
        ]
        if not matches:
            raise KeyError(f"no index named {index_name}")
        if len(matches) > 1:
            # libSQL index names are globally unique; ours are per-table, so
            # an ambiguous name must error rather than silently pick one.
            tables = sorted(t.name for t, _ in matches)
            raise KeyError(
                f"index name {index_name!r} is ambiguous (exists on tables "
                f"{tables}); use table.indexes[...] / knn instead"
            )
        _, bidx = matches[0]
        ids, dists = bidx.index.search(
            np.asarray(query, np.float32)[None, :], k
        )
        keep = ids[0] >= 0
        return {
            "row_ids": ids[0][keep],
            "distance": dists[0][keep],
        }

    # --- table macros (brute force; hnsw_index_macros.cpp:10-113) ---

    def lm_diskann_match(
        self, table, column, query, k, metric=MetricType.L2
    ) -> dict:
        """Brute-force top-k of one query (min_by semantics)."""
        t = self.tables[table] if isinstance(table, str) else table
        metric = MetricType.parse(metric)
        d = evaluate_distance(
            metric, t.columns[column], np.asarray(query, np.float32),
            device=t.device,
        )
        order = np.lexsort((t.row_ids, d))[:k]
        return {"row_ids": t.row_ids[order], "distance": d[order]}

    def lm_diskann_join(self, table, column, queries, k, metric=MetricType.L2):
        """Brute-force batched join macro."""
        t = self.tables[table] if isinstance(table, str) else table
        out = {"query_index": [], "row_ids": [], "distance": [], "rank": []}
        for qi, q in enumerate(np.atleast_2d(queries)):
            r = self.lm_diskann_match(t, column, q, k, metric)
            n = len(r["row_ids"])
            out["query_index"].extend([qi] * n)
            out["row_ids"].extend(r["row_ids"].tolist())
            out["distance"].extend(r["distance"].tolist())
            out["rank"].extend(range(1, n + 1))
        return {k_: np.asarray(v) for k_, v in out.items()}

    # --- pragmas (hnsw_index_pragmas.cpp) ---

    def pragma_lm_diskann_index_info(self) -> list[dict]:
        """pragma_hnsw_index_info() analog: one row per index with
        catalog/metric/dims/count/capacity/memory stats (:22-61)."""
        rows = []
        for tname, t in self.tables.items():
            for iname, bidx in t.indexes.items():
                cfg = bidx.index.config
                info = bidx.index.get_storage_info()
                coord = bidx.index.coordinator
                st = coord.last_search_stats
                rows.append({
                    "catalog_name": self.path or "memory",
                    "table_name": tname,
                    "index_name": iname,
                    "column_name": bidx.column,
                    "metric": cfg.metric_type.value,
                    "edge_type": cfg.resolve_edge_type().value,
                    "dimensions": cfg.dimensions,
                    "r": cfg.r,
                    "l_insert": cfg.l_insert,
                    "l_search": cfg.l_search,
                    "alpha": cfg.alpha,
                    "count": info["count"],
                    "capacity": info["capacity"],
                    "approx_memory_size": info["in_memory_size"],
                    "block_size": info["block_size"],
                    "pending_deletes": len(coord.allocator.pending_deletion),
                    # The reference's level_stats analog for a flat graph:
                    # live out-degree distribution (hnsw_index_pragmas.cpp
                    # :87-150 reports per-level node counts).
                    "degree_stats": _degree_stats(coord),
                    "last_search": st.explain() if st else None,
                })
        return rows

    def lm_diskann_compact_index(self, index_name: str) -> int:
        """Compaction pragma (hnsw_compact_index, :154-190): vacuum the
        deletion queue, recycling slots."""
        for t in self.tables.values():
            if index_name in t.indexes:
                return t.indexes[index_name].index.vacuum()
        raise KeyError(f"no index named {index_name}")

    def checkpoint(self) -> dict:
        """DB checkpoint: persist all dirty indexes (GetStorageInfo /
        PersistToDisk path, hnsw_index.cpp:502-546). Returns the statistics
        of each save, keyed "<table>.<index>"."""
        saved = {}
        if self.path is None:
            return saved
        # Snapshot the catalog: the auto-checkpoint daemon calls this from
        # its own thread while the main thread may create/drop tables or
        # indexes (dict-mutation-during-iteration otherwise).
        for tname, t in list(self.tables.items()):
            for iname, bidx in list(t.indexes.items()):
                if bidx.index.coordinator.dirty:
                    stats = bidx.index.persist_to_disk()
                    if stats is not None:
                        saved[f"{tname}.{iname}"] = stats
        return saved

    # --- auto-checkpoint daemon -------------------------------------------
    # The V2 design's background flush daemon (Consolidated Proposal:
    # 96-107): a thread that periodically merges accumulated deltas into
    # graph.lmd via the incremental two-phase checkpoint, so foreground
    # latency never pays for persistence. Safe concurrently with DML/scan:
    # every LmDiskannIndex method (including persist_to_disk) serializes on
    # its IndexLock, and the checkpoint itself is incremental (O(dirty
    # rows)) and crash-idempotent.

    def start_auto_checkpoint(self, interval_s: float = 30.0) -> None:
        """Start (or retune) the background checkpoint daemon."""
        if self.path is None:
            raise RuntimeError("in-memory database has nothing to persist")
        import threading

        # final_checkpoint=False: starting (or retuning) the daemon must
        # not run a full synchronous checkpoint on the caller's thread —
        # that foreground stall is exactly what the daemon exists to avoid.
        self.stop_auto_checkpoint(final_checkpoint=False)
        self._ckpt_stop = threading.Event()
        self.last_checkpoint_error: Exception | None = None

        def loop(stop: "threading.Event"):
            import logging

            log = logging.getLogger(__name__)
            while not stop.wait(interval_s):
                try:
                    self.checkpoint()
                    self.last_checkpoint_error = None
                except Exception as exc:  # noqa: BLE001 — daemon must not
                    # die; the dirty flag keeps the state
                    # re-checkpointable and the next tick retries. The
                    # failure is logged and surfaced on
                    # last_checkpoint_error so persistent errors (disk
                    # full, corruption) are not silent.
                    self.last_checkpoint_error = exc
                    log.warning("auto-checkpoint failed: %r", exc)

        self._ckpt_thread = threading.Thread(
            target=loop, args=(self._ckpt_stop,), daemon=True
        )
        self._ckpt_thread.start()

    def stop_auto_checkpoint(self, final_checkpoint: bool = True) -> None:
        """Stop the daemon; by default take one final checkpoint."""
        stop = getattr(self, "_ckpt_stop", None)
        if stop is not None:
            stop.set()
            self._ckpt_thread.join()
            self._ckpt_stop = None
            self._ckpt_thread = None
        if final_checkpoint and self.path is not None:
            self.checkpoint()


def _degree_stats(coord) -> dict:
    """Live out-degree distribution: one device reduce, one host read."""
    if coord.count == 0:
        return {"mean": 0.0, "min": 0, "max": 0}
    deg = (coord.arrays.neighbors >= 0).sum(-1)
    live = coord.arrays.valid
    stacked = torch.stack(
        [
            torch.where(live, deg, 0).sum(),
            live.sum().clamp_min(1),
            torch.where(live, deg, coord.params.r).min(),
            torch.where(live, deg, 0).max(),
        ]
    )
    total, n, lo, hi = stacked.cpu().tolist()
    return {"mean": round(total / n, 2), "min": int(lo), "max": int(hi)}


def index_metric_or_default(table: Table, column: str) -> MetricType:
    for bidx in table.indexes.values():
        if bidx.column == column:
            return bidx.index.config.metric_type
    return MetricType.L2


def connect(path: str | None = None, device="cuda") -> Database:
    """Open a database on ``device`` — the extension entry point analog
    (lm_diskann_init)."""
    return Database(path, device=device)
