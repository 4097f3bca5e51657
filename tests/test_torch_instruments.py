"""The port's searcher and insert instruments (``experiments/profile_real``,
``profile_searcher``, ``profile_insert``, ``ab_stream``,
``ab_hard_recall``) on the CPU, against the JAX package where it has an
answer.

The JAX answers are recorded by ``tests/torch_record_instruments.py`` in
``tests/golden/torch_instruments_jax.npz``, so these tests run no JAX
program. Top-k slots, rowids, hops and visit counts must be identical;
distances agree to rtol 1e-5 (f32 summation order); the port's build and
the JAX build have identical tables (edge scales at rtol 1e-6: XLA
multiplies by a rounded reciprocal where the port divides).
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import searcher
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.experiments import (
    ab_hard_recall,
    ab_stream,
    profile_insert,
    profile_real,
    profile_searcher,
)
from tests import torch_record_instruments as rec
from tests.torch_configs import configs
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_answers():
    with np.load(rec.OUT) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def index_data():
    return rec.index_data()


def real_tables(invalid_every=0):
    """profile_real's recorded case as port tables; ``invalid_every`` > 0
    marks every such row dead, so that the validity gather matters."""
    tables = profile_real.tables_from_numpy(*rec.real_tables(), l=rec.REAL_L)
    if invalid_every:
        tables.arrays.valid[::invalid_every] = False
    return tables


def build_port_index(data):
    port_cfg = configs(**rec.index_options())[1]
    coord = Coordinator(port_cfg, initial_capacity=rec.N + 3 * rec.MAX_BATCH,
                        device="cpu")
    coord.bulk_build(range(rec.N), data[: rec.N], max_batch=rec.MAX_BATCH)
    return coord


@pytest.fixture(scope="module")
def port_index(index_data):
    """The port's build of the recorded HARD rows (searched, never
    mutated, by the tests that take it)."""
    return build_port_index(index_data[0])


def assert_same_tables(arrays, jax_answers, prefix):
    got = arrays.to_numpy()
    for name in rec.GRAPH_FIELDS:
        want = jax_answers[f"{prefix}/{name}"]
        have = getattr(got, name)
        assert have.shape == want.shape and have.dtype == want.dtype, name
        if name == "edge_scale":
            np.testing.assert_allclose(have, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)


def test_profile_real_matches_jax_beam_search(jax_answers):
    """Both caps bind (hops == V) and the real searcher's top-k equals the
    JAX beam_search's on the same random tables."""
    rows = profile_real.profile(
        "cpu", real_tables(), v_lo=rec.V_LO, v_hi=rec.V_HI, k=rec.REAL_K,
        reps=1, out=lambda s: None,
    )
    assert rows["batch_hops"] == {rec.V_LO: [rec.V_LO] * 2,
                                  rec.V_HI: [rec.V_HI] * 2}
    assert rows["batches_timed"] == 2
    assert rows["card"] is None  # no card time on the CPU
    assert np.isfinite(rows["wall"]["slope_ms"])
    for v in (rec.V_LO, rec.V_HI):
        res = rows["results"][v]
        assert int(res.hops) == int(jax_answers[f"real/{v}/hops"]) == v
        np.testing.assert_array_equal(
            res.topk_slots.numpy(), jax_answers[f"real/{v}/topk_slots"])
        np.testing.assert_allclose(
            res.topk_dists.numpy(), jax_answers[f"real/{v}/topk_dists"],
            rtol=1e-5)


def test_profile_real_raises_when_the_search_converges():
    """A graph without edges converges after one hop: the cap does not
    bind, and the profile refuses to report a slope."""
    tables = real_tables()
    tables.arrays.neighbors.fill_(-1)
    with pytest.raises(RuntimeError, match="converged"):
        profile_real.profile("cpu", tables, v_lo=rec.V_LO, v_hi=rec.V_HI,
                             reps=1, out=lambda s: None)


@pytest.mark.parametrize("valid", [True, False])
def test_profile_searcher_full_equals_the_searcher_hop(valid):
    """N steps of the mirror with nothing knocked out leave the state that
    N calls of ``searcher._hop`` (``assume_all_valid`` = not ``valid``)
    and beam_search's visited-log append leave."""
    tables = real_tables(invalid_every=7)
    arrays, params, queries = tables
    L, V = params.l_search, params.max_visits
    start = profile_searcher.seed_slots(tables, n=1)[0]
    step = profile_searcher.make_step(tables, nbrlive=valid)
    got = profile_searcher.initial_state(start, L, V)
    for i in range(12):
        got = step(got, i)

    bd, bs, bv, sv, vs, vd, vc = profile_searcher.initial_state(start, L, V)
    seeds_b = torch.zeros((rec.REAL_B, 1), dtype=torch.int32)
    for _ in range(12):
        bd, bs, bv, cur, active, exact = searcher._hop(
            arrays, params, queries[0], None, bd, bs, bv, seeds_b, sv, 1,
            not valid,
        )
        order = active.to(torch.int32).cumsum(-1) - 1
        pos = torch.where(active, vc[:, None] + order, V).clamp_max(V).long()
        vs.scatter_(1, pos, cur)
        vd.scatter_(1, pos, exact)
        vc += active.sum(-1, dtype=torch.int32)
    for name, a, b in zip(
        ("beam_dist", "beam_slot", "beam_vis", "seed_vis", "vis_slot",
         "vis_dist", "vis_cnt"),
        got, (bd, bs, bv, sv, vs, vd, vc),
    ):
        assert torch.equal(a, b), name
    assert int(vc.min()) == 12  # every lane visited at every step


@pytest.mark.parametrize("valid", [True, False])
def test_profile_searcher_every_knockout_runs(valid):
    rows = profile_searcher.knockout(
        "cpu", real_tables(), valid=valid, iters=(2, 4), reps=1,
        out=lambda s: None,
    )
    names = [r["variant"] for r in rows]
    assert names == ["full", "-escore", "-vgather", "-nbrlive", "-vislog",
                     "-merge", "-seedvis", "bare(min)"]
    for r in rows:
        assert np.isfinite(r["ms_per_hop"]) and r["device_ms_per_hop"] is None


def test_port_build_equals_jax_build(port_index, jax_answers):
    assert_same_tables(port_index.arrays, jax_answers, "graph")
    assert port_index.entry_slot == int(jax_answers["graph/entry_slot"])


def test_profile_insert_matches_jax(index_data, jax_answers):
    """Two steady batches, then the candidate search at widths 1 and 2:
    the tables after the batches, the hops and the visit counts equal the
    JAX package's after the same sequence."""
    data = index_data[0]
    coord = build_port_index(data)
    mb = rec.MAX_BATCH
    out = profile_insert.profile(
        coord, range(rec.N, rec.N + 3 * mb), data[rec.N :], mb,
        out=lambda s: None,
    )
    assert coord.max_insert_batch == 1024  # restored
    assert_same_tables(coord.arrays, jax_answers, "insert/graph")
    for width in (1, 2):
        got = out["search"][width]
        counts = jax_answers[f"insert/w{width}/visited_count"]
        assert got["hops"] == int(jax_answers[f"insert/w{width}/hops"])
        assert got["mean_visits"] == pytest.approx(float(counts.mean()),
                                                   rel=1e-12)
        assert got["util"] == pytest.approx(
            counts.mean() / (got["hops"] * width), rel=1e-12)
    assert out["rest_s"] == pytest.approx(
        out["insert_s"] / 2 - out["search"][1]["s"])


def test_ab_hard_recall_matches_jax(port_index, index_data, jax_answers):
    """The baseline and one adaptive configuration: rowids, hops and strict
    recall equal the JAX Coordinator's on the same graph and truth."""
    _, queries, truth_ids, truth_dists = index_data
    cases = tuple(rec.RECALL_CASES.items())
    rows = ab_hard_recall.sweep(
        port_index, queries, truth_ids, truth_dists, k=rec.K, reps=1,
        configs=cases, out=lambda s: None,
    )
    for (name, _), row in zip(cases, rows):
        want_ids = jax_answers[f"recall/{name}/ids"]
        np.testing.assert_array_equal(row["ids"], want_ids)
        assert row["hops"] == int(jax_answers[f"recall/{name}/hops"])
        want = np.mean([len(set(t) & set(r)) / rec.K for t, r in
                        zip(truth_ids.tolist(), want_ids.tolist())])
        assert row["recall"] == pytest.approx(want, rel=1e-12)
        assert 0.0 <= row["eps1"] <= 1.0 and row["qps"] > 0


def test_ab_hard_recall_has_the_twelve_configurations():
    tags = [tag for tag, _ in ab_hard_recall.CONFIGS]
    assert len(tags) == len(set(tags)) == 12
    assert sum(o.get("beam_width", 1) == 2 for _, o in ab_hard_recall.CONFIGS) == 2


def test_ab_stream_matches_lockstep_at_lanes_equal_to_batch(port_index,
                                                            index_data):
    queries = index_data[1]
    out = ab_stream.compare(port_index, queries, batch=8, lanes=(8, 12, 32),
                            reps=1, out=lambda s: None)
    by_lanes = {row["lanes"]: row for row in out["stream"]}
    assert by_lanes[8]["id_match"] == 1.0
    # On the CPU the reductions do not change order with the shape.
    assert by_lanes[12]["id_match"] == by_lanes[32]["id_match"] == 1.0
    many = out["many"]
    assert many["hops"] > 0 and 0.0 < many["util"] <= 1.0
    with pytest.raises(ValueError, match="whole batches"):
        ab_stream.compare(port_index, queries[:20], batch=8, reps=0)
