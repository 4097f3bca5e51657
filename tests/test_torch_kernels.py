"""The INT4 frontier scorer of the PyTorch port.

On the CPU the wrapper runs its plain PyTorch version, held here against
the JAX package's Pallas kernel (interpret mode) and its jnp decode path.
Tolerance rtol = atol = 1e-5, as tests/test_pallas_kernels.py uses: the two
sides sum the D terms in a different f32 order. The CUDA kernel itself is
compared with the plain version by the ``cuda`` tests, which need a card
and skip without one (chip_smoke.py does the same at the headline shapes).
JAX is imported inside the tests that use it, so that the ``cuda`` tests
also run where only the port's dependencies are installed.
"""

import os
import stat

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.common.types import MetricType
from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier
from duckdb_lm_diskann_tpu_torch.ops.quantize import (
    encode_int4_np,
    i4_planar_from_packed_np,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

METRICS = [MetricType.L2, MetricType.IP, MetricType.COSINE]


def _inputs(rng, C=64, R=16, B=12, D=32):
    nbr_vecs = rng.standard_normal((C, R, D)).astype(np.float32)
    packed_u8, scales = encode_int4_np(nbr_vecs)
    words = i4_planar_from_packed_np(packed_u8, D)  # u32 planar words
    words[3, 5:] = 0  # empty edge slots: zero codes, zero scale
    scales[3, 5:] = 0.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    q[0] = 0.0  # zero query: cosine 1.0
    cur = rng.integers(0, C, B).astype(np.int32)
    cur[1] = cur[2] = 3  # repeats, onto the row with empty slots
    return cur, q, words, scales


def _torch(cur, q, words, scales, device="cpu"):
    return (
        torch.from_numpy(cur).to(device),
        torch.from_numpy(q).to(device),
        torch.from_numpy(words.view(np.int32)).to(device),
        torch.from_numpy(scales).to(device),
    )


@pytest.mark.parametrize("d", [32, 40])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_scorer_matches_jax(rng, metric, d):
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.experiments.pallas_kernels import (
        int4_frontier_scores as jax_int4_frontier_scores,
    )
    from duckdb_lm_diskann_tpu.ops.distance import (
        pairwise_distance as jax_pairwise,
    )
    from duckdb_lm_diskann_tpu.ops.quantize import (
        decode_int4 as jax_decode_int4,
    )

    cur, q, words, scales = _inputs(rng, D=d)
    got = int4_frontier.int4_frontier_scores_plain(
        *_torch(cur, q, words, scales), metric=metric
    ).numpy()
    kernel = jax_int4_frontier_scores(
        jnp.asarray(cur), jnp.asarray(q), jnp.asarray(words),
        jnp.asarray(scales), metric=metric, interpret=True,
    )
    vecs = jax_decode_int4(
        jnp.asarray(words)[cur], jnp.asarray(scales)[cur], d
    )
    jnp_path = jax_pairwise(jnp.asarray(q)[:, None, :], vecs, metric)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jnp_path), rtol=1e-5, atol=1e-5)
    if metric is MetricType.COSINE:
        assert (got[0] == 1.0).all()  # zero query
        assert (got[1, 5:] == 1.0).all()  # zero-scale edge slots


def test_wrapper_on_cpu_runs_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(int4_frontier, "LAUNCHES", 0)
    args = _torch(*_inputs(rng))
    for metric in METRICS:
        got = int4_frontier.int4_frontier_scores(*args, metric=metric)
        want = int4_frontier.int4_frontier_scores_plain(*args, metric=metric)
        assert torch.equal(got, want)
    assert int4_frontier.LAUNCHES == 0


def test_wrapper_rejects_bad_inputs(rng):
    cur, q, words, scale = _torch(*_inputs(rng))
    L2 = MetricType.L2
    with pytest.raises(ValueError, match="cur must be"):
        int4_frontier.int4_frontier_scores(cur.long(), q, words, scale, metric=L2)
    with pytest.raises(ValueError, match="contiguous"):
        int4_frontier.int4_frontier_scores(
            cur, q.T.contiguous().T, words, scale, metric=L2
        )
    with pytest.raises(ValueError, match="do not cover"):
        int4_frontier.int4_frontier_scores(
            cur, torch.zeros(len(cur), 33), words, scale, metric=L2
        )
    with pytest.raises(ValueError, match="scale shape"):
        int4_frontier.int4_frontier_scores(
            cur, q, words, scale[:, :3].contiguous(), metric=L2
        )


def test_loader_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(int4_frontier, "_lib", None)
    monkeypatch.setattr(int4_frontier, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(int4_frontier, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        int4_frontier.load_library()
    assert not (tmp_path / "build").exists()


def test_loader_reports_a_failed_build(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(int4_frontier, "_lib", None)
    monkeypatch.setattr(int4_frontier, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(int4_frontier, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        int4_frontier.load_library()
    assert os.listdir(tmp_path / "build") == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 40, 100])
def test_kernel_matches_plain_on_the_card(cuda_device, d):
    before = int4_frontier.LAUNCHES
    rng = np.random.default_rng(d)
    args = _torch(*_inputs(rng, C=256, R=64, B=300, D=d), device=cuda_device)
    for metric in METRICS:
        got = int4_frontier.int4_frontier_scores(*args, metric=metric)
        want = int4_frontier.int4_frontier_scores_plain(*args, metric=metric)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert int4_frontier.LAUNCHES == before + len(METRICS)
