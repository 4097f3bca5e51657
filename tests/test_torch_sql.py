"""The SQL surface of the PyTorch port (``db/``) on the CPU.

Every ``tests/sql/*.sql.test`` file replays through the port's Database:
the files carry their expected results, so no JAX is needed. Then the
cases of ``tests/test_sqltest.py``, ``tests/test_planner.py`` and
``tests/test_concurrent_reads.py`` on the port, with its own brute-force
scan as the reference where they compare with one. Every Database here
asks for the CPU (``device="cpu"``); the port's default is the card.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.db import planner, settings
from duckdb_lm_diskann_tpu_torch.db.database import Database, Table, connect
from duckdb_lm_diskann_tpu_torch.db.functions import (
    ColumnRef,
    Const,
    FunctionExpr,
    cosine_similarity,
    l2 as l2fn,
    sub,
)
from duckdb_lm_diskann_tpu_torch.db.index import LmDiskannIndex
from duckdb_lm_diskann_tpu_torch.db.planner import (
    LogicalGet,
    LogicalIndexScan,
    LogicalProjection,
    LogicalTopKAgg,
    LogicalTopN,
    rewrite_expr,
)
from duckdb_lm_diskann_tpu_torch.db.sqltest import (
    MiniSql,
    SqlTestError,
    run_sqllogic_file,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

SQL_DIR = Path(__file__).parent / "sql"
ALL_SQL_FILES = sorted(SQL_DIR.glob("*.sql.test"))
# The directives of each file that tests/test_sqltest.py holds to a floor.
MIN_DIRECTIVES = {"basic": 7, "int8": 8, "filtered": 7, "cosine_ternary": 9}


def cpu_db(path=None) -> Database:
    return connect(path, device="cpu")


def clustered_data(rng, n, dims, n_clusters=50, spread=0.15):
    """tests/test_build.py's clustered corpus."""
    centers = rng.standard_normal((n_clusters, dims)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    noise = spread * rng.standard_normal((n, dims)).astype(np.float32)
    return centers[assign] + noise


# --------------------------------------------------------------------- #
# the SQL files and the replay harness


@pytest.mark.parametrize(
    "path", ALL_SQL_FILES, ids=[p.name.split(".")[0] for p in ALL_SQL_FILES]
)
def test_sqllogic_file(path):
    db = cpu_db()
    n = run_sqllogic_file(path, db)
    assert n >= MIN_DIRECTIVES.get(path.name.split(".")[0], 4)
    for t in db.tables.values():
        for bidx in t.indexes.values():
            assert bidx.index.coordinator.device.type == "cpu"


def test_sql_files_are_all_replayed():
    assert len(ALL_SQL_FILES) >= 22


def test_mismatch_raises(tmp_path):
    bad = tmp_path / "bad.test"
    bad.write_text(
        "statement ok\nCREATE TABLE t (id INTEGER, vec FLOAT[2])\n\n"
        "statement ok\nINSERT INTO t VALUES (1, [0.0, 0.0])\n\n"
        "query I\nSELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 1\n"
        "----\n99\n"
    )
    with pytest.raises(SqlTestError, match="mismatch"):
        run_sqllogic_file(bad, cpu_db())


def test_minisql_brute_force_without_index():
    sql = MiniSql(cpu_db())
    sql.execute("CREATE TABLE t (id INTEGER, vec FLOAT[2])")
    sql.execute("INSERT INTO t VALUES (7, [0.0, 1.0]), (8, [1.0, 0.0])")
    rows = sql.execute(
        "SELECT id FROM t ORDER BY array_distance(vec, [0.9, 0.1]) LIMIT 1"
    )
    assert rows == [[8]]


def test_statement_error_expectation(tmp_path):
    f = tmp_path / "err.test"
    f.write_text("statement error\nCREATE TABLE t (id INTEGER, vec FLOAT[2]\n")
    run_sqllogic_file(f, cpu_db())


def test_set_boolean_option_parses():
    sql = MiniSql(cpu_db())
    sql.execute("SET lm_diskann_filter_pushdown = false")
    assert sql.db.get_option("lm_diskann_filter_pushdown") is False
    sql.execute("SET lm_diskann_filter_pushdown = true")
    assert sql.db.get_option("lm_diskann_filter_pushdown") is True
    sql.execute("SET lm_diskann_l_search = 42")
    assert sql.db.get_option("lm_diskann_l_search") == 42


# --------------------------------------------------------------------- #
# planner and Database surface


@pytest.fixture
def db_and_table(rng):
    db = cpu_db()
    data = clustered_data(rng, 500, 24, n_clusters=20)
    t = db.create_table("items", {"vec": data, "label": np.arange(500) % 7})
    return db, t, data


L2_OPTS = {"metric": "l2", "r": 16, "l_insert": 32, "l_search": 64}


def test_expr_rewrite_similarity_to_distance():
    a, b = ColumnRef("vec"), Const(np.zeros(4, np.float32))
    out = rewrite_expr(sub(Const(1.0), cosine_similarity(a, b)))
    assert out.name == "array_cosine_distance" and out.args == (a, b)
    assert rewrite_expr(sub(Const(2.0), cosine_similarity(a, b))).name == "-"


def test_topn_rewrites_to_index_scan_and_agrees_with_the_scan(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)
    q = data[3] + 0.01
    res, plan = db.knn(t, "vec", q, 10, metric="l2", return_plan=True)
    assert isinstance(plan, LogicalIndexScan)
    assert len(res["row_ids"]) == 10
    brute = db.lm_diskann_match(t, "vec", q, 10, metric="l2")
    overlap = len(set(res["row_ids"].tolist()) & set(brute["row_ids"].tolist()))
    assert overlap >= 8


def test_topn_without_index_stays_brute_force(db_and_table):
    db, t, data = db_and_table
    res, plan = db.knn(t, "vec", data[0], 5, metric="cosine", return_plan=True)
    assert isinstance(plan, LogicalTopN)
    assert len(res["row_ids"]) == 5 and res["row_ids"][0] == 0


def test_metric_mismatch_prevents_rewrite(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options={"metric": "l2", "r": 16,
                                              "l_insert": 32})
    _, plan = db.knn(t, "vec", data[0], 5, metric="cosine", return_plan=True)
    assert isinstance(plan, LogicalTopN)


def test_residual_filter_pulled_up(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)

    def only_label_zero(table, rowids):
        return table.fetch(rowids, "label") == 0

    res, plan = db.knn(t, "vec", data[0], 10, metric="l2",
                       filter=only_label_zero, return_plan=True)
    assert isinstance(plan, LogicalIndexScan)
    assert (t.fetch(res["row_ids"], "label") == 0).all()
    assert len(res["row_ids"]) <= 10


def test_topk_min_by_rewrite(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)
    agg = LogicalTopKAgg(
        LogicalGet(t), "label", l2fn(ColumnRef("vec"), Const(data[5])), 7
    )
    optimized = planner.optimize(agg)
    assert isinstance(optimized, LogicalProjection)
    assert isinstance(optimized.child, LogicalIndexScan)
    res = planner.execute(optimized)
    assert len(res["row_ids"]) == 7 and "label" in res
    assert res["row_ids"][0] == 5


def test_knn_join_batched(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)
    queries = data[[2, 9, 33]] + 0.01
    res = db.knn_join(t, "vec", queries, 4)
    assert res["row_ids"].shape == (12,)
    np.testing.assert_array_equal(res["rank"], np.tile([1, 2, 3, 4], 3))
    np.testing.assert_array_equal(res["query_index"], np.repeat([0, 1, 2], 4))
    assert res["row_ids"][0] == 2 and res["row_ids"][4] == 9

    db2 = cpu_db()
    res2 = db2.knn_join(db2.create_table("x", {"vec": data}), "vec", queries, 4)
    assert res2["row_ids"].shape == (12,) and res2["row_ids"][0] == 2


def test_scan_state_drains_in_chunks(db_and_table):
    db, t, data = db_and_table
    idx = db.create_index("idx", t, "vec", options=L2_OPTS)
    state = idx.initialize_scan(data[0], 10)
    a = idx.scan(state, max_rows=4)
    b = idx.scan(state, max_rows=4)
    c = idx.scan(state, max_rows=4)
    assert len(a) == 4 and len(b) == 4 and len(c) == 2
    assert state.exhausted
    assert len(set(np.concatenate([a, b, c]).tolist())) == 10


def test_dml_maintains_index(db_and_table):
    db, t, data = db_and_table
    idx = db.create_index("idx", t, "vec", options=L2_OPTS)
    v = data[42] + 0.001
    new_ids = t.insert({"vec": v[None, :], "label": np.asarray([3])})
    assert idx.coordinator.count == 501
    assert db.knn(t, "vec", v, 1, metric="l2")["row_ids"][0] == new_ids[0]
    t.delete(new_ids.tolist())
    assert idx.coordinator.count == 500
    assert db.knn(t, "vec", v, 1, metric="l2")["row_ids"][0] != new_ids[0]


def test_table_fetch_by_row_id(rng):
    """Row ids stay sorted through inserts and deletes; fetch finds rows by
    id and raises KeyError for a missing one."""
    t = Table("x", {"v": np.arange(10.0)}, device="cpu")
    t.delete([2, 5])
    t.insert({"v": np.asarray([10.0, 11.0])})
    np.testing.assert_array_equal(t.row_ids, [0, 1, 3, 4, 6, 7, 8, 9, 10, 11])
    np.testing.assert_array_equal(t.fetch([11, 0, 3], "v"), [11.0, 0.0, 3.0])
    assert t.fetch([], "v").shape == (0,)
    for missing in (2, 12, -1):
        with pytest.raises(KeyError):
            t.fetch([1, missing], "v")


def test_pragma_index_info_and_compact(db_and_table):
    db, t, _ = db_and_table
    db.create_index("idx", t, "vec", options={"metric": "l2", "r": 16,
                                              "l_insert": 32})
    t.delete([1, 2])
    (row,) = db.pragma_lm_diskann_index_info()
    assert row["index_name"] == "idx" and row["metric"] == "l2"
    assert row["dimensions"] == 24 and row["count"] == 498
    assert row["pending_deletes"] == 2
    stats = row["degree_stats"]
    assert 1 <= stats["min"] <= stats["mean"] <= stats["max"] <= 16
    assert db.lm_diskann_compact_index("idx") == 2
    assert db.pragma_lm_diskann_index_info()[0]["pending_deletes"] == 0
    with pytest.raises(KeyError):
        db.lm_diskann_compact_index("nope")


def test_session_setting_overrides_l_search(db_and_table):
    db, t, data = db_and_table
    idx = db.create_index("idx", t, "vec", options={
        "metric": "l2", "r": 16, "l_insert": 32, "l_search": 33})
    idx.search(data[:1], 5)
    assert idx.coordinator.last_search_stats.l_search == 33
    db.set_option("lm_diskann_l_search", 77)
    idx.search(data[:1], 5)
    assert idx.coordinator.last_search_stats.l_search == 77
    with pytest.raises(KeyError):
        db.set_option("bogus_setting", 1)


def test_session_settings_are_per_connection():
    db1, db2 = cpu_db(), cpu_db()
    db1.set_option("lm_diskann_l_search", 123)
    assert db1.get_option("lm_diskann_l_search") == 123
    assert db2.get_option("lm_diskann_l_search") == 0
    assert settings.get_option("lm_diskann_l_search") == 0


def test_create_index_skips_nan_rows(rng):
    db = cpu_db()
    data = clustered_data(rng, 50, 8)
    data[7] = np.nan
    t = db.create_table("x", {"vec": data})
    idx = db.create_index("i", t, "vec", options={"metric": "l2", "r": 8,
                                                  "l_insert": 16})
    assert idx.coordinator.count == 49
    assert 7 not in idx.coordinator.allocator.rowid_to_slot


def test_checkpoint_and_reload(tmp_path, rng, monkeypatch):
    """A new session reuses the checkpoint when the table holds exactly
    the indexed rows (no build), and rebuilds when the vectors changed."""
    data = clustered_data(rng, 100, 8)
    opts = {"metric": "l2", "r": 8, "l_insert": 16}
    db = cpu_db(str(tmp_path / "mydb"))
    db.create_index("i", db.create_table("x", {"vec": data}), "vec", options=opts)
    saved = db.checkpoint()
    assert saved["x.i"] == {"blocks_written": 100, "incremental": False,
                            "high_water": 100, "backend": "native"}
    assert db.checkpoint() == {}  # nothing dirty

    idx2 = LmDiskannIndex("i", data.dtype, 8, options=opts,
                          db_path=str(tmp_path / "mydb"), device="cpu")
    assert idx2.coordinator.count == 100
    ids, _ = idx2.search(data[:2], 3)
    assert (ids[:, 0] == [0, 1]).all()
    idx2.coordinator.shadow_service.close()

    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator

    builds = []
    real = Coordinator.bulk_build
    monkeypatch.setattr(Coordinator, "bulk_build",
                        lambda self, *a, **k: builds.append(1) or real(self, *a, **k))
    db3 = cpu_db(str(tmp_path / "mydb"))
    idx3 = db3.create_index("i", db3.create_table("x", {"vec": data}), "vec",
                            options=opts)
    assert builds == [] and idx3.coordinator.count == 100
    db4 = cpu_db(str(tmp_path / "mydb"))
    idx4 = db4.create_index("i", db4.create_table("x", {"vec": data + 1.0}),
                            "vec", options=opts)
    assert builds == [1] and idx4.coordinator.count == 100


def test_verify_and_to_string(db_and_table):
    db, t, _ = db_and_table
    idx = db.create_index("idx", t, "vec", options={"metric": "l2", "r": 16,
                                                    "l_insert": 32})
    s = idx.verify_and_to_string()
    assert "count=500" in s and "metric=l2" in s
    idx.verify_and_to_string(only_verify=True)


def test_drop_index(tmp_path, rng):
    db = cpu_db(str(tmp_path / "db"))
    t = db.create_table("x", {"vec": clustered_data(rng, 30, 8)})
    idx = db.create_index("i", t, "vec", options={"metric": "l2", "r": 8,
                                                  "l_insert": 16})
    d = idx.directory
    db.checkpoint()
    assert d.exists()
    db.drop_index(t, "i")
    assert not d.exists() and "i" not in t.indexes


def _join_db(rng, with_index=True):
    data = rng.standard_normal((120, 12)).astype(np.float32)
    db = cpu_db()
    t = db.create_table("base", {"vec": data})
    if with_index:
        db.create_index("v", t, "vec", options={
            "metric": "l2", "r": 8, "l_insert": 16, "l_search": 200})
    return db, t, data


def test_lateral_plan_rewrites_to_knn_join(rng):
    db, t, data = _join_db(rng)
    q = rng.standard_normal((5, 12)).astype(np.float32)
    res, plan = db.knn_join(t, "vec", q, 3, return_plan=True)
    assert isinstance(plan, planner.LogicalKnnJoin) and plan.k == 3
    db2, t2, _ = _join_db(rng, with_index=False)
    t2.columns["vec"] = data
    brute, plan2 = db2.knn_join(t2, "vec", q, 3, return_plan=True)
    assert isinstance(plan2, planner.LogicalExprFilter)
    np.testing.assert_array_equal(res["row_ids"], brute["row_ids"])
    np.testing.assert_array_equal(res["rank"], brute["rank"])
    np.testing.assert_array_equal(res["query_index"], brute["query_index"])
    np.testing.assert_allclose(res["distance"], brute["distance"],
                               rtol=1e-5, atol=1e-5)
    assert list(res["rank"][:3]) == [1, 2, 3]


def test_join_matcher_bails_on_wrong_shapes(rng):
    db, t, _ = _join_db(rng)
    qt = Table("qs", {"q": rng.standard_normal((4, 12)).astype(np.float32)},
               device="cpu")

    def lateral(order_expr, pred, ascending=True):
        return planner.LogicalExprFilter(
            planner.LogicalWindow(
                planner.LogicalCrossProduct(
                    planner.LogicalGet(qt), planner.LogicalGet(t)
                ),
                function="row_number", partition="__left_row__",
                order_expr=order_expr, ascending=ascending,
            ),
            pred,
        )

    good = FunctionExpr("array_distance", (
        ColumnRef("q", table="qs"), ColumnRef("vec", table="base")))
    pred = FunctionExpr("<=", (ColumnRef("row_number"), Const(3)))
    assert isinstance(planner.optimize(lateral(good, pred)),
                      planner.LogicalKnnJoin)
    rev = FunctionExpr(">=", (Const(3), ColumnRef("row_number")))
    assert isinstance(planner.optimize(lateral(good, rev)),
                      planner.LogicalKnnJoin)
    cos = FunctionExpr("array_cosine_distance", (
        ColumnRef("q", table="qs"), ColumnRef("vec", table="base")))
    for plan in (
        lateral(cos, pred),  # metric mismatch
        lateral(good, pred, ascending=False),
        lateral(good, FunctionExpr("<=", (ColumnRef("other"), Const(3)))),
    ):
        assert isinstance(planner.optimize(plan), planner.LogicalExprFilter)


def test_vector_top_k_by_index_name(rng):
    data = rng.standard_normal((150, 8)).astype(np.float32)
    db = cpu_db()
    t = db.create_table("x", {"vec": data})
    db.create_index("byname", t, "vec", options={
        "metric": "l2", "r": 8, "l_insert": 16, "l_search": 128})
    res = db.vector_top_k("byname", data[17] + 0.001, 5)
    assert 17 in res["row_ids"].tolist() and len(res["row_ids"]) == 5
    with pytest.raises(KeyError):
        db.vector_top_k("nope", data[0], 3)


def test_merge_projections_collapses_nested(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)
    inner = LogicalProjection(LogicalGet(t), ["vec", "label"])
    outer = LogicalProjection(inner, ["label"])
    plan = LogicalTopN(
        child=LogicalProjection(outer, ["label"]),
        order_expr=l2fn(planner.ColumnRef("vec", t.name), Const(data[2])),
        limit=5,
    )
    optimized = planner.optimize(plan)
    assert isinstance(optimized, LogicalProjection)
    assert optimized.columns == ["label"]
    assert isinstance(optimized.child, LogicalIndexScan)
    res = planner.execute(optimized)
    res.pop("_table", None)
    assert set(res) == {"row_ids", "distance", "label"}
    assert res["row_ids"][0] == 2


def test_adaptive_seeds_session_setting(db_and_table):
    db, t, data = db_and_table
    db.create_index("idx", t, "vec", options=L2_OPTS)
    db.set_option("lm_diskann_adaptive_seeds", 2)
    assert db.knn(t, "vec", data[11], 3, metric="l2")["row_ids"][0] == 11


# --------------------------------------------------------------------- #
# concurrent readers (tests/test_concurrent_reads.py)


def _small_db(rng, n0=64, dims=8):
    db = cpu_db()
    data = rng.standard_normal((n0, dims)).astype(np.float32)
    t = db.create_table("t", {"v": data})
    db.create_index("idx", t, "v", options={
        "metric": "l2", "r": 4, "l_insert": 8, "l_search": 16})
    return db, t, data


def test_concurrent_readers_and_writer_no_torn_state(rng):
    """Readers search captured views with no index lock while a writer
    inserts and deletes: results are real row ids with finite distances,
    and reads overlap writes."""
    dims = 8
    db, t, data = _small_db(rng, dims=dims)
    idx = t.indexes["idx"].index
    stop = threading.Event()
    errors: list[BaseException] = []
    reads, writes, overlapped = [0], [0], [0]
    write_active = [False]
    first_read = threading.Event()

    def reader(tid):
        q = data[tid % len(data)]
        try:
            while not stop.is_set():
                before = write_active[0]
                ids, dists = idx.search(q[None, :], 3)
                if before or write_active[0]:
                    overlapped[0] += 1
                ids = ids[0]
                assert all(i == -1 or 0 <= i < 100000 for i in ids.tolist())
                assert np.isfinite(dists[0][ids >= 0]).all()
                reads[0] += 1
                first_read.set()
        except BaseException as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    def writer():
        try:
            first_read.wait(timeout=120)
            deadline = time.monotonic() + 90
            next_id = 1000
            while not stop.is_set() and (
                writes[0] < 12
                or (overlapped[0] == 0 and time.monotonic() < deadline)
            ):
                vecs = rng.standard_normal((4, dims)).astype(np.float32)
                write_active[0] = True
                t.insert({"v": vecs})
                if writes[0] % 3 == 2:
                    t.delete([next_id - 1000 + 64])
                write_active[0] = False
                next_id += 4
                writes[0] += 1
                time.sleep(0.01)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            write_active[0] = False

    readers = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    wt = threading.Thread(target=writer)
    for r in readers:
        r.start()
    wt.start()
    wt.join(timeout=300)
    stop.set()
    for r in readers:
        r.join(timeout=60)
    assert not wt.is_alive() and not any(r.is_alive() for r in readers)
    assert not errors, errors
    assert writes[0] >= 12 and reads[0] > 0
    assert overlapped[0] > 0, "no read overlapped a write; test too weak"


def test_reader_gate_disables_donation_only_under_readers(rng):
    """A mutation under a live reader runs without donation (copies), so
    the held view still answers as at capture; with no reader the
    in-place path is back."""
    db, t, data = _small_db(rng)
    idx = t.indexes["idx"].index
    coord = idx.coordinator
    seen = {}
    orig = coord.insert

    def spy_insert(rowids, vectors):
        seen["donate"] = coord.donate_buffers
        return orig(rowids, vectors)

    coord.insert = spy_insert
    with idx._reader() as view:
        before = coord.search(data[:8], 3, view=view)
        t.insert({"v": rng.standard_normal((2, 8)).astype(np.float32)})
        assert seen["donate"] is False
        after = coord.search(data[:8], 3, view=view)
        np.testing.assert_array_equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
        assert after[0][0][0] == 0 and view.count == 64
    t.insert({"v": rng.standard_normal((2, 8)).astype(np.float32)})
    assert seen["donate"] is True
