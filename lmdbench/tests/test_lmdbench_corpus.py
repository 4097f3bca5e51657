"""The frozen corpus copy against the repository's generator, and the
run seed's role."""

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.utils.corpora import make_corpus as original
from lmdbench import corpus


@pytest.mark.parametrize("seed,dims", [(0xBE7C4, 128), (0x61577, 960),
                                       (0, 16)])
def test_frozen_copy_is_bit_identical(seed, dims):
    g0, r0 = original(0, dims, seed=seed)
    g1, r1 = corpus.make_corpus(0, dims, seed=seed)
    np.testing.assert_array_equal(g0(300), g1(300))
    np.testing.assert_array_equal(g0(7), g1(7))
    assert r0.integers(0, 2**62) == r1.integers(0, 2**62)


def _inputs(seed):
    config = {"dims": 16, "manifold_seed": 0xBE7C4, "rows": 200}
    return corpus.make_inputs(config, {"pool": 30, "stream_rows": 40}, seed)


def test_same_seed_same_inputs_and_stream_order():
    a, b = _inputs(2**31 + 77), _inputs(2**31 + 77)
    np.testing.assert_array_equal(a.base, b.base)
    np.testing.assert_array_equal(a.pool, b.pool)
    np.testing.assert_array_equal(a.stream_rows(40), b.stream_rows(40))
    # Drawing past the first block continues one stream.
    more = a.stream_rows(90)
    np.testing.assert_array_equal(more[:40], b.stream_rows(40))
    np.testing.assert_array_equal(a.rows(250)[200:], more[:50])


def test_seeds_draw_other_rows_of_one_manifold():
    a, b = _inputs(1), _inputs(2**40 + 1)
    assert a.base.shape == b.base.shape and a.pool.shape == b.pool.shape
    assert not np.array_equal(a.base, b.base)
    # One manifold: the rows' spread agrees closely across seeds.
    np.testing.assert_allclose(a.base.std(0), b.base.std(0), rtol=0.35)


def test_stream_slices_are_the_stream_in_order():
    a, b = _inputs(5), _inputs(5)
    first = a.stream_slice(0, 40)
    assert first.base is not None  # a view of the pre-drawn block
    chunks = [a.stream_slice(s, s + 10) for s in range(40, 90, 10)]
    across = a.stream_slice(35, 45)
    whole = b.stream_rows(40)
    for s in range(40, 90, 10):
        b.stream_slice(s, s + 10)
    np.testing.assert_array_equal(np.concatenate([first, *chunks]),
                                  b.stream_rows(90))
    np.testing.assert_array_equal(across, b.stream_rows(90)[35:45])
    np.testing.assert_array_equal(first, whole)
