"""The frontier scorers of the PyTorch port: INT4, TERNARY and INT8.

On the CPU each wrapper runs its plain PyTorch version, held here against
the JAX package's Pallas kernels (interpret mode) and its jnp paths:
TERNARY scores are integers and must be equal; INT4 and INT8 distances
agree to rtol = atol = 1e-5, as tests/test_pallas_kernels.py uses, because
the two sides sum the D terms in a different f32 order. The CUDA kernels
themselves are compared with the plain versions by the ``cuda`` tests,
which need a card and skip without one (chip_smoke.py does the same at the
main path's shapes). JAX is imported inside the tests that use it, so that
the ``cuda`` tests also run where only the port's dependencies are
installed.
"""

import os
import stat

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import MetricType
from duckdb_lm_diskann_tpu_torch.kernels import (
    _build,
    int4_frontier,
    int8_frontier,
    ternary_frontier,
)
from duckdb_lm_diskann_tpu_torch.ops.quantize import (
    encode_int4_np,
    encode_int8_np,
    i4_planar_from_packed_np,
)
from duckdb_lm_diskann_tpu_torch.ops.ternary import encode_ternary_np
from tests.torch_configs import METRIC_NAMES, metrics
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

METRICS = [MetricType.L2, MetricType.IP, MetricType.COSINE]
KERNELS = [int4_frontier, ternary_frontier, int8_frontier]


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


def _ternary_inputs(rng, C=64, R=16, B=12, D=64):
    """u32 planes of random vectors; row 3 has empty slots (zero planes)
    and is repeated in ``cur``."""
    ep, en = encode_ternary_np(rng.standard_normal((C, R, D)).astype(np.float32))
    ep[3, 5:] = en[3, 5:] = 0
    qp, qn = encode_ternary_np(rng.standard_normal((B, D)).astype(np.float32))
    cur = rng.integers(0, C, B).astype(np.int32)
    cur[1] = cur[2] = 3
    return cur, qp, qn, ep, en


def _ternary_torch(cur, qp, qn, ep, en, device="cpu"):
    return tuple(
        torch.from_numpy(a.view(np.int32)).to(device)
        for a in (cur, qp, qn, ep, en)
    )


def _int8_inputs(rng, C=64, R=16, B=12, D=32):
    codes, scales = encode_int8_np(
        rng.standard_normal((C, R, D)).astype(np.float32)
    )
    codes[3, 5:] = 0  # empty edge slots: zero codes, zero scale
    scales[3, 5:] = 0.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    q[0] = 0.0
    cur = rng.integers(0, C, B).astype(np.int32)
    cur[1] = cur[2] = 3
    return cur, q, codes, scales


def _int8_torch(cur, q, codes, scales, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in (cur, q, codes, scales))


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

    jmetric, metric = metrics(metric.value)
    cur, q, words, scales = _inputs(rng, D=d)
    got = int4_frontier.int4_frontier_scores_plain(
        *_torch(cur, q, words, scales), metric=metric
    ).numpy()
    kernel = jax_int4_frontier_scores(
        jnp.asarray(cur), jnp.asarray(q), jnp.asarray(words),
        jnp.asarray(scales), metric=jmetric, interpret=True,
    )
    vecs = jax_decode_int4(
        jnp.asarray(words)[cur], jnp.asarray(scales)[cur], d
    )
    jnp_path = jax_pairwise(jnp.asarray(q)[:, None, :], vecs, jmetric)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jnp_path), rtol=1e-5, atol=1e-5)
    if metric is MetricType.COSINE:
        assert (got[0] == 1.0).all()  # zero query
        assert (got[1, 5:] == 1.0).all()  # zero-scale edge slots


@pytest.mark.parametrize("d", [64, 100, 960])
def test_ternary_plain_scorer_matches_jax(rng, d):
    """W = 2, 4 and 30 words: equal to both Pallas kernels (row-at-a-time
    and K-deep, interpret mode) and to the jnp path."""
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.experiments.pallas_kernels import (
        ternary_frontier_scores as jax_scores,
    )
    from duckdb_lm_diskann_tpu.experiments.pallas_kernels import (
        ternary_frontier_scores_deep as jax_scores_deep,
    )
    from duckdb_lm_diskann_tpu.ops.ternary import ternary_dot as jax_dot

    cur, qp, qn, ep, en = _ternary_inputs(rng, D=d)
    got = ternary_frontier.ternary_frontier_scores_plain(
        *_ternary_torch(cur, qp, qn, ep, en)
    )
    assert got.dtype == torch.int32 and got.shape == (len(cur), ep.shape[1])
    j = [jnp.asarray(a) for a in (cur, qp, qn, ep, en)]
    want = np.asarray(jax_scores(*j, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (3, 8):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_scores_deep(*j, n_flight=k, interpret=True))
        )
    jnp_path = jax_dot(j[1][:, None, :], j[2][:, None, :], j[3][cur], j[4][cur])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp_path))
    assert (got[1, 5:] == 0).all()  # empty slots score 0


@pytest.mark.parametrize("d", [32, 100])
@pytest.mark.parametrize("metric", METRIC_NAMES)
def test_int8_plain_scorer_matches_jax(rng, metric, d):
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.experiments.pallas_kernels import (
        int8_frontier_scores as jax_int8_frontier_scores,
    )
    from duckdb_lm_diskann_tpu.ops.distance import (
        pairwise_distance as jax_pairwise,
    )

    jmetric, metric = metrics(metric)
    cur, q, codes, scales = _int8_inputs(rng, D=d)
    got = int8_frontier.int8_frontier_scores_plain(
        *_int8_torch(cur, q, codes, scales), metric=metric
    ).numpy()
    kernel = jax_int8_frontier_scores(
        jnp.asarray(cur), jnp.asarray(q), jnp.asarray(codes),
        jnp.asarray(scales), metric=jmetric, interpret=True,
    )
    vecs = jnp.asarray(codes)[cur].astype(jnp.float32) * jnp.asarray(
        scales
    )[cur][..., None]
    jnp_path = jax_pairwise(jnp.asarray(q)[:, None, :], vecs, jmetric)
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


def test_ternary_and_int8_wrappers_on_cpu_run_the_plain_versions(
    rng, monkeypatch
):
    monkeypatch.setattr(ternary_frontier, "LAUNCHES", 0)
    monkeypatch.setattr(int8_frontier, "LAUNCHES", 0)
    t_args = _ternary_torch(*_ternary_inputs(rng, D=100))
    assert torch.equal(
        ternary_frontier.ternary_frontier_scores(*t_args),
        ternary_frontier.ternary_frontier_scores_plain(*t_args),
    )
    i_args = _int8_torch(*_int8_inputs(rng))
    for metric in METRICS:
        assert torch.equal(
            int8_frontier.int8_frontier_scores(*i_args, metric=metric),
            int8_frontier.int8_frontier_scores_plain(*i_args, metric=metric),
        )
    assert ternary_frontier.LAUNCHES == 0 and int8_frontier.LAUNCHES == 0


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


def test_ternary_and_int8_wrappers_reject_bad_inputs(rng):
    from duckdb_lm_diskann_tpu.common.types import MetricType as JaxMetric

    cur, qp, qn, ep, en = _ternary_torch(*_ternary_inputs(rng))
    with pytest.raises(ValueError, match="q_pos must be"):
        ternary_frontier.ternary_frontier_scores(cur, qp.long(), qn, ep, en)
    with pytest.raises(ValueError, match="do not match"):
        ternary_frontier.ternary_frontier_scores(
            cur, qp, qn, ep[..., :1].contiguous(), en
        )
    with pytest.raises(ValueError, match="q_neg shape"):
        ternary_frontier.ternary_frontier_scores(cur, qp, qn[:2], ep, en)
    cur, q, codes, scale = _int8_torch(*_int8_inputs(rng))
    with pytest.raises(ValueError, match="codes must be"):
        int8_frontier.int8_frontier_scores(
            cur, q, codes.float(), scale, metric=MetricType.L2
        )
    with pytest.raises(ValueError, match="codes of 32 dims"):
        int8_frontier.int8_frontier_scores(
            cur, q[:, :30].contiguous(), codes, scale, metric=MetricType.L2
        )
    with pytest.raises(ValueError, match="Unsupported metric"):
        int8_frontier.int8_frontier_scores(
            cur, q, codes, scale, metric=JaxMetric.L2
        )


def _point_builds_at(monkeypatch, tmp_path, nvcc):
    for kernel in KERNELS:
        monkeypatch.setattr(kernel.LIBRARY, "_fn", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)


def test_loader_without_nvcc_raises(tmp_path, monkeypatch):
    _point_builds_at(monkeypatch, tmp_path, None)
    for kernel in KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernel.LIBRARY.function()
    assert not (tmp_path / "build").exists()


def test_loader_reports_a_failed_build(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    _point_builds_at(monkeypatch, tmp_path, str(fake))
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        int4_frontier.LIBRARY.function()
    assert os.listdir(tmp_path / "build") == []


def test_parallel_build_reports_every_failure(tmp_path, monkeypatch):
    """build_libraries starts one nvcc per source at once and names each
    source that failed; a failed build leaves no file behind."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\nfor a; do src=$a; done\n"
        "echo \"error: cannot build $(basename $src)\"\nexit 1\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    _point_builds_at(monkeypatch, tmp_path, str(fake))
    with pytest.raises(RuntimeError) as err:
        _build.build_libraries([k.LIBRARY for k in KERNELS])
    for name in ("int4_frontier.cu", "ternary_frontier.cu", "int8_frontier.cu"):
        assert f"cannot build {name}" in str(err.value)
    assert os.listdir(tmp_path / "build") == []
    assert all(k.LIBRARY._fn is None for k in KERNELS)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 960, 2100])
def test_ternary_kernel_equals_plain_on_the_card(cuda_device, d):
    """W = 2, 4, 30 and 66 words (one lane group per row up to a whole
    warp, and more words than lanes): scores exactly equal."""
    before = ternary_frontier.LAUNCHES
    rng = np.random.default_rng(d)
    args = _ternary_torch(
        *_ternary_inputs(rng, C=256, R=64, B=300, D=d), device=cuda_device
    )
    got = ternary_frontier.ternary_frontier_scores(*args)
    want = ternary_frontier.ternary_frontier_scores_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ternary_frontier.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 100, 30])
def test_int8_kernel_matches_plain_on_the_card(cuda_device, d):
    """D = 128 and 100 take the 4-byte word path, D = 30 the byte path."""
    before = int8_frontier.LAUNCHES
    rng = np.random.default_rng(d)
    args = _int8_torch(
        *_int8_inputs(rng, C=256, R=64, B=300, D=d), device=cuda_device
    )
    for metric in METRICS:
        got = int8_frontier.int8_frontier_scores(*args, metric=metric)
        want = int8_frontier.int8_frontier_scores_plain(*args, metric=metric)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert int8_frontier.LAUNCHES == before + len(METRICS)
