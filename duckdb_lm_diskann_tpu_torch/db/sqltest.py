"""SQL-logic-test replay harness.

The reference's primary intended test method is sqllogictest files
(test/sql/basic.sql.test: ``require lm_diskann`` + ``statement ok`` /
``query`` blocks with ``----`` expected results, run through DuckDB's
unittest runner — SURVEY §4). This module replays the same file format
against this framework's Database surface, supporting the SQL subset the
vector-index surface uses:

    CREATE TABLE t (id INTEGER, vec FLOAT[D])
    INSERT INTO t VALUES (1, [0.1, 0.2, ...]), ...
    CREATE INDEX idx ON t USING LM_DISKANN (vec) WITH (METRIC='l2', ...)
    SELECT id FROM t ORDER BY array_distance(vec, [..]) LIMIT k
    DELETE FROM t WHERE id = n
    PRAGMA lm_diskann_index_info
    PRAGMA lm_diskann_compact_index('idx')

This doubles as the bit-identical replay check: run the reference's query
set, diff returned row ids.

Counterpart of ``duckdb_lm_diskann_tpu/db/sqltest.py``, driving the port's
Database: a file replays on the card by default, or on the device of the
Database passed in (``run_sqllogic_file(path, Database(device="cpu"))``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..common.types import MetricType
from . import planner
from .database import Database
from .functions import ColumnRef, Const, FunctionExpr

_DIST_FUNCS = {
    "array_distance": MetricType.L2,
    "array_cosine_distance": MetricType.COSINE,
    "array_negative_inner_product": MetricType.IP,
}
# similarity spellings accepted in ORDER BY (rewritten by the expression
# optimizer when written as 1.0 - fn(...), hnsw_optimize_expr.cpp:18-75)
_ALL_FUNCS = set(_DIST_FUNCS) | {
    "array_cosine_similarity",
    "array_inner_product",
}

_CMP_OPS = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class SqlTestError(AssertionError):
    pass


def _parse_vector(text: str) -> np.ndarray:
    return np.asarray([float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", text)],
                      np.float32)


def _parse_order_expr(text: str):
    """ORDER BY expression -> planner Expr. Supported shapes (the operand
    forms the reference's TopN matcher accepts, hnsw_optimize_scan.cpp:
    83-130, plus the similarity form its expression optimizer rewrites):

        fn(col, [v]) | fn([v], col) | <const> - fn(col, [v])
    """
    text = text.strip()
    m = re.match(r"(-?\d+\.?\d*)\s*-\s*(.*)$", text)
    shift = None
    if m:
        shift = float(m.group(1))
        text = m.group(2).strip()
    m = re.match(r"(\w+)\s*\(\s*([^()]*)\)\s*$", text)
    if not m or m.group(1) not in _ALL_FUNCS:
        raise SqlTestError(f"unsupported ORDER BY expression: {text!r}")
    fn = m.group(1)
    args = []
    for a in re.split(r",(?![^\[]*\])", m.group(2)):
        a = a.strip()
        if a.startswith("["):
            args.append(Const(_parse_vector(a)))
        else:
            args.append(ColumnRef(a))
    expr = FunctionExpr(fn, tuple(args))
    if shift is not None:
        expr = FunctionExpr("-", (Const(shift), expr))
    return expr


_PLAN_NAMES = {
    planner.LogicalIndexScan: "LM_DISKANN_INDEX_SCAN",
    planner.LogicalTopN: "TOP_N",
    planner.LogicalTopKAgg: "TOPK_AGG",
    planner.LogicalProjection: "PROJECTION",
    planner.LogicalGet: "SEQ_SCAN",
    planner.LogicalKnnJoin: "KNN_JOIN",
    planner.LogicalWindow: "WINDOW",
    planner.LogicalCrossProduct: "CROSS_PRODUCT",
    planner.LogicalExprFilter: "FILTER",
    planner.LogicalFilter: "FILTER",
}


def _plan_lines(op) -> list:
    """Flatten a plan top-down into one operator name per row — the EXPLAIN
    surface the reference's rewrite tests grep (e.g. asserting
    HNSW_INDEX_SCAN appears after the TopN optimization)."""
    name = _PLAN_NAMES.get(type(op), type(op).__name__)
    if isinstance(op, planner.LogicalIndexScan) and op.residual_filter is not None:
        name += "(residual_filter)"
    if isinstance(op, planner.LogicalGet) and op.filter is not None:
        name += "(filtered)"
    rows = [[name]]
    for attr in ("child", "left", "right"):
        c = getattr(op, attr, None)
        if isinstance(c, planner.LogicalOp):
            rows.extend(_plan_lines(c))
    return rows


class MiniSql:
    """Executes the supported SQL subset against a Database."""

    def __init__(self, db: Database | None = None):
        self.db = db or Database()

    def execute(self, sql: str):
        sql = sql.strip().rstrip(";")
        low = sql.lower()

        m = re.match(r"create\s+table\s+(\w+)\s*\((.*)\)\s*$", low, re.S)
        if m:
            name = m.group(1)
            cols = {}
            for cdef in re.split(r",(?![^\[]*\])", m.group(2)):
                parts = cdef.strip().split()
                cname, ctype = parts[0], " ".join(parts[1:])
                am = re.match(r"(float|real|tinyint)\s*\[\s*(\d+)\s*\]", ctype)
                if am:
                    # TINYINT[N] -> int8 column (ARRAY(TINYINT, N): the
                    # reference's int8 vector columns,
                    # db/LmDiskannIndex.cpp:137-154)
                    dt = np.int8 if am.group(1) == "tinyint" else np.float32
                    cols[cname] = np.empty((0, int(am.group(2))), dt)
                else:
                    cols[cname] = np.empty((0,), np.int64)
            self.db.create_table(name, cols)
            return []

        m = re.match(r"insert\s+into\s+(\w+)\s+values\s*(.*)$", low, re.S)
        if m:
            t = self.db.tables[m.group(1)]
            rows = re.findall(r"\(((?:[^()\[\]]|\[[^\]]*\])*)\)", m.group(2))
            col_names = list(t.columns)
            values = {c: [] for c in col_names}
            for row in rows:
                fields = re.split(r",(?![^\[]*\])", row)
                for c, f in zip(col_names, fields):
                    f = f.strip()
                    if f.startswith("["):
                        values[c].append(_parse_vector(f))
                    else:
                        values[c].append(int(float(f)))
            arrs = {}
            for c in col_names:
                if t.columns[c].ndim == 2:
                    arrs[c] = np.asarray(values[c]).astype(t.columns[c].dtype)
                else:
                    arrs[c] = np.asarray(values[c], np.int64)
            t.insert(arrs)
            return []

        m = re.match(
            r"create\s+index\s+(\w+)\s+on\s+(\w+)\s+using\s+lm_diskann\s*"
            r"\(\s*(\w+)\s*\)(?:\s+with\s*\((.*)\))?\s*$",
            low, re.S,
        )
        if m:
            options = {}
            if m.group(4):
                for kv in m.group(4).split(","):
                    k, v = kv.split("=")
                    options[k.strip()] = v.strip().strip("'\"")
            self.db.create_index(m.group(1), m.group(2), m.group(3), options=options)
            return []

        explain = False
        m = re.match(r"explain\s+(.*)$", low, re.S)
        if m:
            explain = True
            low = m.group(1).strip()

        # SELECT <cols> FROM vector_top_k('idx', [q], k) — libSQL's
        # by-index-name top-k virtual table (vectorIndexInt.h:228-236).
        m = re.match(
            r"select\s+([\w,\s]+)\s+from\s+vector_top_k\(\s*'(\w+)'\s*,"
            r"\s*(\[[^\]]*\])\s*,\s*(\d+)\s*\)\s*$",
            low, re.S,
        )
        if m:
            cols = [c.strip() for c in m.group(1).split(",")]
            res = self.db.vector_top_k(
                m.group(2), _parse_vector(m.group(3)), int(m.group(4))
            )
            res["rowid"] = res.pop("row_ids")
            return [
                [int(res[c][i]) if c == "rowid" else res[c][i]
                 for c in cols]
                for i in range(len(res["rowid"]))
            ]

        # SELECT <cols> FROM knn_join(t, col, [[..],[..]], k) — the lateral
        # top-k join surface (optimized into one batched MultiScan,
        # hnsw_optimize_join.cpp; rank is 1-indexed like the reference).
        m = re.match(
            r"select\s+([\w,\s]+)\s+from\s+knn_join\(\s*(\w+)\s*,\s*(\w+)\s*,"
            r"\s*(\[\s*\[.*\]\s*\])\s*,\s*(\d+)\s*\)\s*$",
            low, re.S,
        )
        if m:
            cols = [c.strip() for c in m.group(1).split(",")]
            queries = np.asarray(
                [_parse_vector(row)
                 for row in re.findall(r"\[([^\[\]]*)\]", m.group(4))],
                np.float32,
            )
            res, plan = self.db.knn_join(
                m.group(2), m.group(3), queries, int(m.group(5)),
                return_plan=True,
            )
            if explain:
                return _plan_lines(plan)
            res = dict(res)
            res["rowid"] = res.pop("row_ids")
            n = len(res["rowid"])
            return [
                [int(res[c][i]) for c in cols] for i in range(n)
            ]

        # SELECT <out> | min_by(<out>, <dist>, k) FROM t [WHERE col op num]
        # [ORDER BY <expr> [ASC] LIMIT k]
        m = re.match(
            r"select\s+(.*?)\s+from\s+(\w+)"
            r"(?:\s+where\s+(\w+)\s*(=|!=|<>|<=|>=|<|>)\s*(-?\d+(?:\.\d+)?))?"
            r"(?:\s+order\s+by\s+(.*?)\s*(?:asc\s*)?limit\s+(\d+))?\s*$",
            low, re.S,
        )
        if m:
            sel, tname, wcol, wop, wval, order_text, k = m.groups()
            t = self.db.tables[tname]
            flt = None
            if wcol is not None:
                # WHERE col op const: the residual filter the optimizer
                # pulls up above the index scan / pushes down as a filtered
                # search (hnsw_optimize_scan.cpp:160-200).
                want = float(wval)
                cmp = _CMP_OPS[wop]

                def flt(table, rowids, _c=wcol, _f=cmp, _v=want):
                    if _c == "rowid":
                        return _f(np.asarray(rowids, np.float64), _v)
                    return _f(
                        np.asarray(table.fetch(rowids, _c), np.float64), _v
                    )

            get = planner.LogicalGet(t, filter=flt)
            mb = re.match(
                r"min_by\(\s*(\w+)\s*,\s*(.*)\s*,\s*(\d+)\s*\)\s*$", sel, re.S
            )
            if mb:
                # AGG min_by(ret, dist, k) (hnsw_optimize_topk.cpp:51-228)
                out_col = mb.group(1)
                plan = planner.LogicalTopKAgg(
                    get, out_col, _parse_order_expr(mb.group(2)),
                    int(mb.group(3)),
                )
            else:
                if order_text is None:
                    raise SqlTestError(f"unsupported SQL: {sql!r}")
                out_col = sel.strip()
                # Projection between TopN and the scan — the shape the TopN
                # matcher must see through (hnsw_optimize_scan.cpp:33-78).
                proj_cols = [] if out_col == "rowid" else [out_col]
                plan = planner.LogicalTopN(
                    planner.LogicalProjection(get, proj_cols),
                    _parse_order_expr(order_text),
                    int(k),
                )
            optimized = planner.optimize(plan)
            if explain:
                return _plan_lines(optimized)
            res = planner.execute(optimized)
            res.pop("_table", None)
            if out_col == "rowid":
                return [[int(r)] for r in res["row_ids"]]
            if out_col in res:
                vals = res[out_col]
            else:
                vals = t.fetch(res["row_ids"], out_col)
            return [[v.item() if hasattr(v, "item") else v] for v in vals]

        m = re.match(r"delete\s+from\s+(\w+)\s+where\s+(\w+)\s*=\s*(\d+)\s*$", low)
        if m:
            t = self.db.tables[m.group(1)]
            col, val = m.group(2), int(m.group(3))
            if col == "rowid":
                t.delete([val])
            else:
                mask = t.columns[col] == val
                t.delete(t.row_ids[mask].tolist())
            return []

        m = re.match(r"set\s+(\w+)\s*=\s*'?([\w.]+)'?\s*$", low)
        if m:
            # Session option (SET lm_diskann_l_search = ..., the
            # hnsw_ef_search analog, hnsw_index.cpp:667-675).
            name, val = m.group(1), m.group(2)
            if val in ("true", "on"):
                value = True  # boolean options (filter_pushdown,
            elif val in ("false", "off"):
                value = False  # enable_persistence) — a raw string
                # "false" would be truthy and silently do nothing
            else:
                try:
                    value = int(val)
                except ValueError:
                    try:
                        value = float(val)
                    except ValueError:
                        value = val
            self.db.set_option(name, value)
            return []

        m = re.match(r"pragma\s+lm_diskann_index_info\s*$", low)
        if m:
            return [
                [r["index_name"], r["metric"], r["dimensions"], r["count"]]
                for r in self.db.pragma_lm_diskann_index_info()
            ]

        m = re.match(r"pragma\s+lm_diskann_compact_index\s*\(\s*'(\w+)'\s*\)\s*$", low)
        if m:
            return [[self.db.lm_diskann_compact_index(m.group(1))]]

        raise SqlTestError(f"unsupported SQL: {sql!r}")


def run_sqllogic_file(path: str | Path, db: Database | None = None) -> int:
    """Replay a sqllogictest file. Returns the number of directives run;
    raises SqlTestError on any mismatch."""
    sql = MiniSql(db)
    text = Path(path).read_text()
    blocks = re.split(r"\n\s*\n", text)
    executed = 0
    for block in blocks:
        lines = [
            ln for ln in block.splitlines()
            if ln.strip() and not ln.strip().startswith("#")
        ]
        if not lines:
            continue
        head = lines[0].split()
        if head[0] == "require":
            # 'require lm_diskann' — always satisfied here.
            executed += 1
            continue
        if head[0] == "load" or head[0] == "mode":
            executed += 1
            continue
        if head[0] == "statement":
            expect_ok = head[1] == "ok"
            stmt = "\n".join(lines[1:])
            failure: Exception | None = None
            try:
                sql.execute(stmt)
            except Exception as e:  # noqa: BLE001 - any failure counts
                failure = e
            if expect_ok and failure is not None:
                raise SqlTestError(
                    f"statement failed: {stmt}: {failure}"
                ) from failure
            if not expect_ok and failure is None:
                raise SqlTestError(f"statement unexpectedly succeeded: {stmt}")
            executed += 1
            continue
        if head[0] == "query":
            body = lines[1:]
            if "----" in body:
                sep = body.index("----")
                stmt = "\n".join(body[:sep])
                expected = [ln.strip() for ln in body[sep + 1 :]]
            else:
                stmt = "\n".join(body)
                expected = None
            rows = sql.execute(stmt)
            got = ["\t".join(str(v) for v in row) for row in rows]
            if expected is not None and got != expected:
                raise SqlTestError(
                    f"query result mismatch for {stmt!r}:\n"
                    f"  got:      {got}\n  expected: {expected}"
                )
            executed += 1
            continue
        raise SqlTestError(f"unknown directive {head[0]!r}")
    return executed
