"""The plain reference against NumPy on a tiny corpus, and the TF32
control's rounding."""

import numpy as np
import pytest
import torch

from lmdbench import reference


def _numpy_dist(q, x, metric):
    q = q.astype(np.float64)[:, None, :]
    x = x.astype(np.float64)[None, :, :]
    if metric == "l2":
        return np.sqrt(((q - x) ** 2).sum(-1))
    dot = (q * x).sum(-1)
    if metric == "ip":
        return -dot
    norm = np.linalg.norm(q, axis=-1) * np.linalg.norm(x, axis=-1)
    return 1.0 - np.clip(dot / norm, -1.0, 1.0)


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_exact_topk_matches_numpy(metric, monkeypatch):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((700, 24)).astype(np.float32)
    queries = rng.standard_normal((37, 24)).astype(np.float32)
    # Small blocks: the running top-k merges across many row blocks.
    monkeypatch.setattr(reference, "QUERY_BLOCK", 16)
    monkeypatch.setattr(reference, "BLOCK_BYTES", 16 * 4 * 64)
    ids, d = reference.exact_topk(rows, queries, 10, metric, "cpu")
    full = _numpy_dist(queries, rows, metric)
    ids_grid = np.broadcast_to(np.arange(700), full.shape)
    want = np.lexsort((ids_grid, full))[:, :10]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(d, np.take_along_axis(full, want, 1),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_pair_distances_are_float64(metric, monkeypatch):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((50, 960)).astype(np.float32)
    queries = rng.standard_normal((5, 960)).astype(np.float32)
    q_idx = rng.integers(0, 5, 300)
    ids = rng.integers(0, 50, 300)
    monkeypatch.setattr(reference, "BLOCK_BYTES", 4 * 960 * 8 * 7)
    got = reference.pair_distances(rows, queries, q_idx, ids, metric, "cpu")
    full = _numpy_dist(queries, rows, metric)
    np.testing.assert_allclose(got, full[q_idx, ids], rtol=1e-13, atol=1e-13)


def test_cosine_of_a_zero_vector_is_one():
    rows = np.zeros((3, 8), np.float32)
    rows[1] = 1.0
    got = reference.pair_distances(rows, rows[1:2], [0, 0], [0, 1],
                                   "cosine", "cpu")
    np.testing.assert_allclose(got, [1.0, 0.0], atol=1e-15)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 3 * 2**-12)])
    np.testing.assert_array_equal(
        reference.tf32(x).numpy(),
        np.float32([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10)]))


def test_control_distances_are_tf32_not_exact():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((400, 128)).astype(np.float32)
    queries = rng.standard_normal((20, 128)).astype(np.float32)
    ids, d = reference.control_topk(rows, queries, 10, "l2", "cpu")
    exact = reference.pair_distances(
        rows, queries, np.repeat(np.arange(20), 10), ids.reshape(-1), "l2",
        "cpu").reshape(ids.shape)
    err = np.abs(d - exact) / exact
    assert 1e-5 < err.max() < 1e-1
