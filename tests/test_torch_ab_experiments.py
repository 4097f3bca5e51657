"""The port's A/B experiments (``experiments/ab_insert_width``,
``ab_width_iso``, ``ab_hard_build``, ``ab_int4_layout``) on the CPU.

The first three against the JAX package: ``tests/torch_record_ab.py``
replays each ``benchmarks/`` script's calls at a small size (N = 512, D =
16, the graph options scaled down, the same options on both sides) into
``tests/golden/torch_ab_jax.npz``, so these tests run no JAX program.
Rowids, hops and the recall values must be identical and distances agree
to rtol 1e-5 (f32 summation order). ``ab_int4_layout``'s five rows agree
with ``ops/quantize.decode_int4_np``'s distances; its reference's ``cur``
row (the bytes read as planar words by the JAX package's
``decode_int4``) does not.
"""

import json

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import MetricType, VectorType
from duckdb_lm_diskann_tpu_torch.experiments import (
    ab_hard_build,
    ab_hard_recall,
    ab_insert_width,
    ab_int4_layout,
    ab_width_iso,
)
from duckdb_lm_diskann_tpu_torch.kernels.int4_frontier import (
    int4_frontier_scores,
)
from duckdb_lm_diskann_tpu_torch.ops.quantize import (
    decode_int4_np,
    i4_planar_from_packed_np,
)
from tests import torch_record_ab as rec
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_answers():
    with np.load(rec.OUT) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def manifold():
    return rec.manifold_case()


def assert_same_answer(ids, dists, want_ids, want_dists, what):
    np.testing.assert_array_equal(ids, want_ids, err_msg=what)
    np.testing.assert_allclose(dists, want_dists, rtol=1e-5, err_msg=what)


def same_sets(a, b):
    return all(set(x) == set(y) for x, y in zip(a.tolist(), b.tolist()))


@pytest.mark.parametrize("insert_width", rec.INSERT_WIDTHS)
def test_ab_insert_width_matches_jax(insert_width, manifold, jax_answers):
    """One insert width's build, served at every serving width through
    the script's ``beam_search`` calls."""
    data, queries = manifold
    truth, _ = ab_hard_recall.exact_topk(data, queries, rec.K, MetricType.L2,
                                         "cpu")
    np.testing.assert_array_equal(truth, jax_answers["insert_width/truth"])
    coord, build_s, refine_s = ab_insert_width.build(
        data, device="cpu", max_batch=rec.MAX_BATCH, r=rec.R,
        l_insert=rec.L_INSERT, alpha=rec.ALPHA,
        insert_beam_width=insert_width)
    assert build_s > 0 and refine_s == 0.0
    assert ab_insert_width.steady_rate(coord) > 0
    assert coord.params.insert_beam_width == insert_width
    for width in rec.SERVE_WIDTHS:
        row = ab_insert_width.serve(coord, queries, truth, width, k=rec.K,
                                    l_search=rec.INSERT_L, batch=rec.B,
                                    reps=1)
        key = f"insert_width/{insert_width}/{width}"
        assert_same_answer(row["ids"], row["dists"], jax_answers[f"{key}/ids"],
                           jax_answers[f"{key}/dists"], key)
        assert row["hops"] == jax_answers[f"{key}/hops"].tolist(), key
        assert row["recall"] == ab_hard_recall.recall(
            jax_answers[f"{key}/ids"], jax_answers["insert_width/truth"],
            rec.K)


@pytest.mark.parametrize("node_type", ["float32", "int8"])
def test_ab_width_iso_matches_jax(node_type, manifold, jax_answers):
    """The W x L grid (FLOAT32 nodes) or the INT8-node arm through the
    script's ``beam_search_many`` calls; the INT8 build stores the float
    rows exactly as the JAX builder does (round, clip, no scale)."""
    data, queries = manifold
    truth = ab_width_iso.ground_truth(data, queries, rec.K, "cpu")
    assert same_sets(truth, jax_answers["width_iso/truth"])
    coord, _, _ = ab_insert_width.build(
        data, device="cpu", max_batch=rec.MAX_BATCH, r=rec.R,
        l_insert=rec.L_INSERT, alpha=rec.ALPHA,
        node_vector_type=VectorType(node_type))
    if node_type == "int8":
        stored = coord.arrays.vectors[: rec.N].numpy()
        want = jax_answers["width_iso/int8/vectors"][: rec.N]
        assert stored.dtype == want.dtype == np.int8
        np.testing.assert_array_equal(stored, want)
        np.testing.assert_array_equal(
            stored, ab_width_iso.stored_vectors(data, "int8"))
        grid = [(1, L) for L in rec.ISO_INT8_LS]
    else:
        grid = [(w, L) for w in rec.ISO_WIDTHS for L in rec.ISO_LS]
    for width, L in grid:
        row = ab_width_iso.serve(coord, queries, truth, width, L, k=rec.K,
                                 batch=rec.B, reps=1)
        key = f"width_iso/{node_type}/{width}/{L}"
        assert_same_answer(row["ids"], row["dists"], jax_answers[f"{key}/ids"],
                           jax_answers[f"{key}/dists"], key)
        assert row["hops"] == jax_answers[f"{key}/hops"].tolist(), key
        assert row["recall"] == ab_hard_recall.recall(
            jax_answers[f"{key}/ids"], jax_answers["width_iso/truth"], rec.K)


@pytest.mark.parametrize("name", list(rec.HARD_CONFIGS))
def test_ab_hard_build_matches_jax(name, jax_answers):
    """One build configuration (refine, R = 96 and alpha arms scaled down)
    and its adaptive-seed searches at each L."""
    data, queries = rec.hard_case()
    # 5% exact duplicates: the two top-10s may pick different rows of a tie
    # at the 10th distance, so the f64 distances of their rows are
    # compared, and both sides' recall is taken against the JAX truth.
    ids, _ = ab_hard_recall.exact_topk(data, queries, rec.K, MetricType.L2,
                                       "cpu")
    truth = jax_answers["hard_build/truth"]

    def exact(rows):
        diff = queries[:, None, :].astype(np.float64) - data[rows]
        return np.sort(np.sqrt((diff * diff).sum(-1)), axis=1)

    np.testing.assert_allclose(exact(ids), exact(truth), rtol=1e-6)
    res = ab_hard_build.sweep(
        data, queries, truth, device="cpu", configs=rec.HARD_CONFIGS,
        which=[name], ls=rec.HARD_LS, k=rec.K, max_batch=rec.MAX_BATCH,
        report=lambda label, row: None)[name]
    assert (res["refine_s"] > 0) == rec.HARD_CONFIGS[name][3]
    for L in rec.HARD_LS:
        row, key = res["by_l"][L], f"hard_build/{name}/{L}"
        assert_same_answer(row["ids"], row["dists"], jax_answers[f"{key}/ids"],
                           jax_answers[f"{key}/dists"], key)
        assert row["hops"] == int(jax_answers[f"{key}/hops"]), key
        assert row["recall"] == ab_hard_recall.recall(
            jax_answers[f"{key}/ids"], jax_answers["hard_build/truth"], rec.K)


def test_ab_hard_build_has_the_five_configurations():
    assert ab_hard_build.CONFIGS == {
        "base": (64, 128, 1.2, False), "refine": (64, 128, 1.2, True),
        "r96": (96, 192, 1.2, False), "r96refine": (96, 192, 1.2, True),
        "a13refine": (64, 128, 1.3, True),
    }
    assert ab_hard_build.LS == (100, 150, 200)
    assert ab_hard_build.SEARCH_OPTS == rec.HARD_SEARCH


# ab_int4_layout at CAP = 256 rows, B = 16, R = 8, D = 128.
@pytest.fixture(scope="module")
def int4_tables():
    return ab_int4_layout.make_tables("cpu", cap_log2=8, b=16, r=8, d=128,
                                      chunk_log2=6)


def test_ab_int4_layout_planar_words_equal_the_host_converter(int4_tables):
    t = int4_tables
    want = i4_planar_from_packed_np(t["u8"].numpy(), 128)
    np.testing.assert_array_equal(t["w"].numpy().view(np.uint32), want)


def test_ab_int4_layout_rows_agree_with_decode_int4_np(int4_tables):
    t = int4_tables
    cur = torch.randint(0, t["cap"], (16,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3))
    ref = ab_int4_layout.reference(cur, t)
    v = decode_int4_np(t["u8"][cur.long()].numpy(), t["sc"][cur.long()].numpy(),
                       128)
    np.testing.assert_allclose(
        ref, ((t["q"].numpy()[:, None, :] - v) ** 2).sum(-1), rtol=1e-5)
    for name in ("cur", "planar"):
        got = ab_int4_layout.SCORES[name](cur, t).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    for name in ("dot", "dotn2"):
        got = ab_int4_layout.SCORES[name](cur, t).numpy()
        err = np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0))
        assert err < ab_int4_layout.DOT_RTOL, (name, err)
    errs = ab_int4_layout.check(t)
    assert set(errs) == {"cur", "planar", "dot", "dotn2", "kernel"}


def test_ab_int4_layout_kernel_cpu_form_equals_planar(int4_tables):
    t = int4_tables
    cur = torch.arange(16, dtype=torch.int32) * 13 % t["cap"]
    d = int4_frontier_scores(cur, t["q"], t["w"], t["sc"],
                             metric=MetricType.L2)
    np.testing.assert_allclose((d * d).numpy(),
                               ab_int4_layout.score_planar(cur, t).numpy(),
                               rtol=1e-5)
    times = ab_int4_layout.time_rows(t, iters=(2, 4), reps=1,
                                     out=lambda s: None)
    assert set(times) == set(ab_int4_layout.SCORES)
    assert all(v["card_ms"] is None for v in times.values())


def test_ab_int4_layout_reference_cur_decodes_other_values(int4_tables):
    """The reference's ``cur`` row handed the interleaved bytes to the JAX
    package's planar ``decode_int4``: other vectors, other distances."""
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.ops.quantize import decode_int4

    t = int4_tables
    cur = torch.arange(16, dtype=torch.int32)
    packed = t["u8"][cur.long()].numpy()
    scale = t["sc"][cur.long()].numpy()
    wrong = np.asarray(decode_int4(jnp.asarray(packed), jnp.asarray(scale),
                                   128))
    right = decode_int4_np(packed, scale, 128)
    assert wrong.shape == right.shape
    assert np.abs(wrong - right).max() > 1.0
    q = t["q"].numpy()[:, None, :]
    wrong_d = ((q - wrong) ** 2).sum(-1)
    np.testing.assert_allclose(ab_int4_layout.score_cur(cur, t).numpy(),
                               ((q - right) ** 2).sum(-1), rtol=1e-5)
    assert not np.allclose(wrong_d, ab_int4_layout.reference(cur, t),
                           rtol=1e-3)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ab_insert_width_main_on_the_cpu(capsys):
    """``python -m ...ab_insert_width 32 --device cpu``: the script's own
    sweep, one row per insert width x serving width."""
    assert ab_insert_width.main(["32", "--device", "cpu"]) == 0
    rows = last_json(capsys)["ab_insert_width"]
    assert [(r["insert_width"], r["serve_width"]) for r in rows] == [
        (i, s) for i in ab_insert_width.INSERT_WIDTHS
        for s in ab_insert_width.SERVE_WIDTHS]
    assert all(r["recall"] == 1.0 and min(r["hops"]) > 0 for r in rows)


def test_ab_width_iso_main_on_the_cpu(capsys, monkeypatch):
    """``python -m ...ab_width_iso 32 --device cpu`` (64 queries in one
    batch, for the CPU's sake): the W x L grid and the INT8-node arm."""
    monkeypatch.setattr(ab_width_iso, "N_QUERIES", 64)
    assert ab_width_iso.main(["32", "--device", "cpu"]) == 0
    res = last_json(capsys)["ab_width_iso"]
    assert [(r["width"], r["l_search"]) for r in res["float32"]["rows"]] == [
        (w, L) for w in ab_width_iso.WIDTHS for L in ab_width_iso.LS]
    assert [r["l_search"] for r in res["int8"]["rows"]] == list(
        ab_width_iso.INT8_LS)
    assert all(r["recall"] == 1.0 for r in res["float32"]["rows"])


def test_ab_hard_build_main_on_the_cpu(capsys):
    """``python -m ...ab_hard_build 32 base,refine --device cpu``: the
    named configurations only, each at every L."""
    assert ab_hard_build.main(["32", "base,refine", "--device", "cpu"]) == 0
    res = last_json(capsys)
    assert list(res) == ["base", "refine"]
    assert res["base"]["refine_s"] == 0.0 < res["refine"]["refine_s"]
    assert all(set(row) == {"build_s", "refine_s", "recall_L100",
                            "recall_L150", "recall_L200"}
               for row in res.values())
    with pytest.raises(SystemExit):
        ab_hard_build.main(["32", "base,wide", "--device", "cpu"])
