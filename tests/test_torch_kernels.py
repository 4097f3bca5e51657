"""The kernels of the PyTorch port: the INT4, TERNARY and INT8 frontier
scorers and the row gather of the hop profiler.

On the CPU each wrapper runs its plain PyTorch version, held here against
the JAX package's Pallas kernels (interpret mode) and its jnp paths:
TERNARY scores are integers and must be equal; INT4 and INT8 distances
agree to rtol = atol = 1e-5, as tests/test_pallas_kernels.py uses, because
the two sides sum the D terms in a different f32 order. The CUDA kernels
themselves are compared with the plain versions by the ``cuda`` tests,
which need a card and skip without one (chip_smoke.py does the same at the
main path's shapes). The row gather's plain version is held against the hop
profiler's Pallas kernels (``benchmarks/profile_hop.py``, interpret mode),
and the kernel against the plain version exactly, on the card. JAX is
imported inside the tests that use it, so that
the ``cuda`` tests also run where only the port's dependencies are
installed.
"""

import importlib.util
import os
import stat
import sys

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.common.types import MetricType
from duckdb_lm_diskann_tpu_torch.kernels import (
    _build,
    beam_merge,
    int4_frontier,
    int8_frontier,
    row_gather,
    ternary_frontier,
)
from duckdb_lm_diskann_tpu_torch.ops.quantize import (
    encode_int4_np,
    encode_int8_np,
    i4_planar_from_packed_np,
)
from duckdb_lm_diskann_tpu_torch.ops.ternary import encode_ternary_np
from tests.torch_configs import METRIC_NAMES, metrics
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

METRICS = [MetricType.L2, MetricType.IP, MetricType.COSINE]
KERNELS = [int4_frontier, ternary_frontier, int8_frontier, row_gather,
           beam_merge]


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


SMS = 132  # an H100 SXM's streaming multiprocessors


T4, I8 = ternary_frontier.BLOCKS_PER_SM, int4_frontier.BLOCKS_PER_SM
B8 = int8_frontier.BLOCKS_PER_SM


@pytest.mark.parametrize(
    "stage, n_queries, pointers, blocks, most, want",
    [
        # TERNARY W=30 (GIST), B=1024: 4 blocks a SM, 3 stages, bulk.
        (ternary_frontier.stage_bytes(64, 30), 1024, [0, 4096, 16, 32],
         [64 * 30 * 4], T4, (528, 3, True)),
        # W=66 (D=2100): a 34 KB stage still gets 3 stages, at 2 blocks a SM.
        (ternary_frontier.stage_bytes(64, 66), 5000, [0, 16, 32, 48],
         [64 * 66 * 4], T4, (264, 3, True)),
        # B=1: one block.
        (ternary_frontier.stage_bytes(64, 2), 1, [0, 16, 32, 48], [512], T4,
         (1, 4, True)),
        # R=5, W=30: a 600-byte plane block takes the vector branch.
        (ternary_frontier.stage_bytes(5, 30), 7, [0, 16, 32, 48], [600], T4,
         (7, 4, False)),
        # INT4 D=128, B=2048 (the headline build): 8 blocks a SM, bulk.
        (int4_frontier.stage_bytes(64, 128, 16), 2048, [0, 16, 32],
         [4096, 256], I8, (1056, 4, True)),
        # A table view 8 bytes off a 16-byte boundary: vector branch.
        (int4_frontier.stage_bytes(64, 128, 16), 1024, [0, 8, 32],
         [4096, 256], I8, (1024, 4, False)),
        # R=13: 52 bytes of scales a node, vector branch.
        (int4_frontier.stage_bytes(13, 100, 13), 256, [0, 16, 32],
         [13 * 13 * 4, 13 * 4], I8, (256, 4, False)),
        # INT8 D=128 (the L2 default), B=1024: an 8,976-byte stage, 8
        # blocks a SM with 3 stages each, bulk.
        (int8_frontier.stage_bytes(64, 128), 1024, [0, 16, 32],
         [8192, 256], B8, (1024, 3, True)),
        # B=2048: the grid stops at 8 blocks a SM.
        (int8_frontier.stage_bytes(64, 128), 2048, [0, 16, 32],
         [8192, 256], B8, (1056, 3, True)),
        # A code table a byte off a 16-byte boundary: vector branch.
        (int8_frontier.stage_bytes(64, 128), 1024, [0, 1, 32],
         [8192, 256], B8, (1024, 3, False)),
        # R=13, D=30: 390-byte code blocks, vector branch.
        (int8_frontier.stage_bytes(13, 30), 7, [0, 16, 32], [390, 52], B8,
         (7, 4, False)),
        # D=960: a 65,552-byte stage takes one block a SM and 3 stages.
        (int8_frontier.stage_bytes(64, 960), 1024, [0, 16, 32],
         [64 * 960, 256], B8, (132, 3, True)),
    ],
    ids=["ternary_w30", "ternary_w66", "ternary_b1", "ternary_r5",
         "int4_d128", "int4_misaligned", "int4_r13", "int8_d128",
         "int8_d128_b2048", "int8_misaligned", "int8_r13_d30", "int8_d960"],
)
def test_ring_plan(stage, n_queries, pointers, blocks, most, want):
    """grid = min(B, k * SMs) with k <= the kernel's blocks a SM; S >= 2
    stages where two fit, S * stage within a block's 227 KB and k blocks
    within a SM's 228 KB; bulk copies only for 16-byte aligned tables and
    blocks."""
    plan = _build.ring_plan(n_queries, SMS, stage, pointers, blocks, most)
    assert (plan.grid, plan.stages, plan.bulk) == want
    k = next(k for k in (most, most // 2, most // 4, 1)
             if plan.grid == min(n_queries, k * SMS))
    assert k * (plan.stages * stage + _build.RING_STATIC_BYTES + 1024) <= (
        _build.SM_SHARED_BYTES
    )
    assert plan.stages >= 2 or 2 * stage > _build.BLOCK_SHARED_BYTES
    assert plan.stages * stage <= (
        _build.BLOCK_SHARED_BYTES - _build.RING_STATIC_BYTES
    )
    assert plan.stage_bytes == stage


def test_ring_plan_at_the_shared_memory_limit():
    """A stage that fits only once runs with S = 1 at one block a SM; one
    that does not fit at all is refused, on the CPU too."""
    limit = _build.BLOCK_SHARED_BYTES - _build.RING_STATIC_BYTES
    plan = _build.ring_plan(4096, SMS, limit, [0], [16], I8)
    assert (plan.grid, plan.stages) == (SMS, 1)
    with pytest.raises(ValueError, match="exceeds"):
        _build.ring_plan(4096, SMS, limit + 16, [0], [16], T4)
    edges = torch.zeros((2, 64, 500), dtype=torch.int32)
    q = torch.zeros((3, 500), dtype=torch.int32)
    cur = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        ternary_frontier.ternary_frontier_scores(cur, q, q, edges, edges)
    codes = torch.zeros((2, 640, 100), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        int4_frontier.int4_frontier_scores(
            cur, torch.zeros((3, 800)), codes, torch.zeros((2, 640)),
            metric=MetricType.L2,
        )


def test_int8_stage_sizes_and_pieces_on_the_cpu():
    """INT8's stage is [rows*D codes][rows scales][query window], each
    16-byte aligned (8,976 bytes for a whole node at R=64, D=128). A node
    too large for two stages of a block is scored in pieces of
    ``stage_rows`` rows, so every R keeps working up to D = 12,288 and
    beyond; only a stage that not even one row fits is refused, by the
    CUDA path's plan. The CPU path has no such limit."""
    assert int8_frontier.stage_bytes(64, 128) == 8192 + 256 + 512 + 16
    assert int8_frontier.stage_bytes(13, 30) == 400 + 64 + 128 + 16
    limit = _build.BLOCK_SHARED_BYTES - _build.RING_STATIC_BYTES
    rows = int8_frontier.stage_rows
    assert rows(64, 128) == rows(64, 960) == 64  # whole nodes
    assert rows(5, 12288) == 5
    # Pieces: R=128, D=3072 in 4 of 32 rows; R=64, D=4096 in 24+24+16;
    # R=13, D=12288 in 4+4+4+1 (a multiple of 4 from 4 on).
    assert (rows(128, 3072), rows(64, 4096), rows(13, 12288)) == (32, 24, 4)
    for r in (5, 13, 64, 128, 256):
        for d in (3072, 4096, 12288):
            n = rows(r, d)
            assert 1 <= n <= r and 2 * int8_frontier.stage_bytes(n, d) <= limit
            plan = _build.ring_plan(1024 * -(-r // n), SMS,
                                    int8_frontier.stage_bytes(n, d), [0],
                                    [r * d, r * 4, n * d, n * 4], B8)
            assert plan.stages >= 2, (r, d, plan)
    # One row and the query fit once at D = 46,000, never at D = 47,000.
    assert rows(64, 46000) == 1
    plan = _build.ring_plan(64, SMS, int8_frontier.stage_bytes(1, 46000),
                            [0], [46000, 4], B8)
    assert (plan.grid, plan.stages, plan.bulk) == (64, 1, False)
    with pytest.raises(ValueError, match="exceeds"):
        _build.ring_plan(64, SMS, int8_frontier.stage_bytes(1, 47000), [0],
                         [47000, 4], B8)
    # The CPU path at R=64, D=4096 against float64 numpy.
    rng = np.random.default_rng(4096)
    codes = rng.integers(-128, 128, (3, 64, 4096), dtype=np.int8)
    scale = (0.005 * rng.random((3, 64))).astype(np.float32)
    q = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    cur = np.array([2, 0], dtype=np.int32)
    got = int8_frontier.int8_frontier_scores(
        torch.from_numpy(cur), torch.from_numpy(q), torch.from_numpy(codes),
        torch.from_numpy(scale), metric=MetricType.L2)
    v = codes[cur].astype(np.float64) * scale[cur][..., None]
    want = np.sqrt(((q[:, None, :].astype(np.float64) - v) ** 2).sum(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


ALIGNED = [(0, 256)]  # a table and its output, both 16-byte aligned
FOUR = [128, 64, 64, 1024]  # the hop profiler's four SoA tables, in words


@pytest.mark.parametrize(
    "n_rows, n_flight, widths, pointers, want",
    [
        # B=1 and 7: one group of 320 16-byte units, two blocks.
        (1, 8, [1280], ALIGNED, (2, 1, (320,), (True,))),
        (7, 16, [1280], ALIGNED, (2, 1, (320,), (True,))),
        # B=1024 (the profiler's batch): K sets the groups and the grid.
        (1024, 4, [1280], ALIGNED, (320, 256, (320,), (True,))),
        (1024, 8, [1280], ALIGNED, (160, 128, (320,), (True,))),
        (1024, 16, [1280], ALIGNED, (80, 64, (320,), (True,))),
        # The four SoA tables: a group's units are the sum of theirs.
        (1024, 8, FOUR, ALIGNED * 4,
         (160, 128, (32, 16, 16, 256), (True,) * 4)),
        (5000, 4, [1280], ALIGNED, (1563, 1250, (320,), (True,))),
        (16384, 8, [1280], ALIGNED, (2560, 2048, (320,), (True,))),
        # X=130: a ragged width moves 4-byte words.
        (1024, 8, [130], ALIGNED, (65, 128, (130,), (False,))),
        # A table view, or an output, 4 bytes off a 16-byte boundary.
        (1024, 8, [1280], [(4, 256)], (640, 128, (1280,), (False,))),
        (1024, 8, [1280], [(0, 260)], (640, 128, (1280,), (False,))),
        (1024, 16, FOUR, ALIGNED * 3 + [(52, 0)],
         (272, 64, (32, 16, 16, 1024), (True, True, True, False))),
        # No rows, or rows of width 0: nothing to launch.
        (0, 8, [1280], ALIGNED, (0, 0, (320,), (True,))),
        (1024, 8, [0], ALIGNED, (0, 128, (0,), (True,))),
    ],
    ids=["b1", "b7_k16", "b1024_k4", "b1024", "b1024_k16", "four_tables",
         "b5000_k4", "b16384", "x130", "misaligned", "misaligned_out",
         "four_misaligned", "b0", "width0"],
)
def test_gather_plan(n_rows, n_flight, widths, pointers, want):
    """ceil(B / K) groups of K rows; a thread per 16-byte unit of a row
    (a width of 4k words, both pointers 16-byte aligned) or else per 4-byte
    word; blocks = ceil(groups x units / kThreads)."""
    plan = _build.gather_plan(n_rows, n_flight, widths, pointers,
                              row_gather.THREADS)
    assert (plan.blocks, plan.groups, plan.units, plan.vec) == want
    assert plan.threads == row_gather.THREADS
    assert plan.blocks * plan.threads >= plan.groups * sum(plan.units)


def test_gather_plan_raises():
    """A negative row count, an n_flight below 1 and a grid past 2^31 - 1
    blocks (which the entry point refuses) are refused."""
    for n_rows, n_flight in ((-1, 8), (1024, 0)):
        with pytest.raises(ValueError, match="rows"):
            _build.gather_plan(n_rows, n_flight, [1280], ALIGNED, 256)
    with pytest.raises(ValueError, match="grid"):
        _build.gather_plan(2**31 - 1, 1, [1 << 20], [(4, 0)], 256)


def _constant(source: str, name: str) -> int:
    import re

    text = (_build.CSRC / source).read_text()
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    assert len(found) == 1, f"{source}: {name} defined {len(found)} times"
    return int(found[0])


@pytest.mark.parametrize(
    "source, name, mirror",
    [
        ("int4_frontier.cu", "kBlocksPerSm", int4_frontier.BLOCKS_PER_SM),
        ("int8_frontier.cu", "kBlocksPerSm", int8_frontier.BLOCKS_PER_SM),
        ("ternary_frontier.cu", "kBlocksPerSm",
         ternary_frontier.BLOCKS_PER_SM),
        ("ring.cuh", "kMaxStages", _build.RING_MAX_STAGES),
        ("row_gather.cu", "kThreads", row_gather.THREADS),
        ("beam_merge.cu", "kThreads", beam_merge.THREADS),
    ],
    ids=["int4", "int8", "ternary", "ring", "gather_threads",
         "merge_threads"],
)
def test_kernel_constants_match_their_wrappers(source, name, mirror):
    """Each constant a wrapper copies by hand from a CUDA source (the
    blocks a SM, stages or threads a block its launch plan assumes) equals
    the source's, read from the text: no nvcc needed."""
    assert _constant(source, name) == mirror


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
    for name in ("int4_frontier.cu", "ternary_frontier.cu", "int8_frontier.cu",
                 "row_gather.cu", "beam_merge.cu"):
        assert f"cannot build {name}" in str(err.value)
    assert os.listdir(tmp_path / "build") == []
    assert all(k.LIBRARY._fn is None for k in KERNELS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 40, 100, 30, 128])
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
    """W = 2, 4, 30 and 66 words (lane groups of 1, 2 and 4 lanes a row,
    one to nine word pairs a lane): scores exactly equal."""
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


def _ring_curs(gen, dev, b, C):
    """B rows with repeats and out-of-range slots, and the same rows
    clamped into [0, C) for the plain version (which indexes, and so does
    not clamp)."""
    cur = torch.randint(0, C, (b,), dtype=torch.int32, device=dev, generator=gen)
    cur[1::7] = cur[0]
    if b > 3:
        cur[2], cur[3] = -5, C + 9
    return cur, cur.clamp(0, C - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [5, 13, 64])
def test_ternary_ring_equals_plain_on_the_card(cuda_device, r):
    """The persistent ring at B = 1, 7, 1024 and 5000 (many wraps of the
    ring), W = 2, 4, 30, 66, with repeated and out-of-range rows: scores
    exactly equal, in the bulk branch where R*W*4 is a multiple of 16, and
    in the vector branch for a misaligned view (table[1:] of 600-byte
    blocks, query planes [1:] of 120-byte rows)."""
    gen = torch.Generator(device=cuda_device).manual_seed(r)
    C = 512

    def planes(shape):
        p = torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                          device=cuda_device, generator=gen)
        n = torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                          device=cuda_device, generator=gen)
        return p, n & ~p

    for w in (2, 4, 30, 66):
        ep, en = planes((C, r, w))
        for b in (1, 7, 1024, 5000):
            qp, qn = planes((b, w))
            cur, clamped = _ring_curs(gen, cuda_device, b, C)
            got = ternary_frontier.ternary_frontier_scores(cur, qp, qn, ep, en)
            plan = ternary_frontier.LAST_PLAN
            want = ternary_frontier.ternary_frontier_scores_plain(
                clamped, qp, qn, ep, en)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (w, b, plan)
            assert plan.bulk == (r * w * 4 % 16 == 0)
    ep, en = planes((C + 1, 5, 30))
    qp, qn = planes((1025, 30))
    views = [t[1:] for t in (qp, qn, ep, en)]
    cur, clamped = _ring_curs(gen, cuda_device, 1024, C)
    got = ternary_frontier.ternary_frontier_scores(cur, *views)
    assert not ternary_frontier.LAST_PLAN.bulk
    torch.cuda.synchronize()
    assert torch.equal(
        got, ternary_frontier.ternary_frontier_scores_plain(clamped, *views))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [5, 13, 64])
def test_int4_ring_matches_plain_on_the_card(cuda_device, r):
    """The persistent ring at B = 1, 7, 1024 and 5000, D = 30, 40, 100,
    128, L2/IP/cosine, with repeated and out-of-range rows: within rtol =
    atol = 1e-5 (another f32 sum order), in the bulk branch where R % 4 ==
    0 (odd-sized query rows through their 16-byte windows) and the vector
    branch otherwise, and for a misaligned view of the tables."""
    gen = torch.Generator(device=cuda_device).manual_seed(r)
    C = 512

    def tables(c, d):
        codes = torch.randint(-(2**31), 2**31, (c, r, (d + 7) // 8),
                              dtype=torch.int32, device=cuda_device,
                              generator=gen)
        scale = 0.05 * torch.rand((c, r), device=cuda_device, generator=gen)
        scale[:, ::4] = 0.0  # empty edge slots
        return codes, scale

    for d in (30, 40, 100, 128):
        codes, scale = tables(C, d)
        for b in (1, 7, 1024, 5000):
            q = torch.randn((b, d), device=cuda_device, generator=gen)
            q[0] = 0.0  # zero query: cosine 1.0
            cur, clamped = _ring_curs(gen, cuda_device, b, C)
            for metric in METRICS:
                got = int4_frontier.int4_frontier_scores(
                    cur, q, codes, scale, metric=metric)
                plan = int4_frontier.LAST_PLAN
                want = int4_frontier.int4_frontier_scores_plain(
                    clamped, q, codes, scale, metric=metric)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                           msg=f"{d} {b} {metric} {plan}")
            assert plan.bulk == (r % 4 == 0)
    # q[1:] of 120-byte rows starts 8 bytes off a 16-byte boundary.
    codes, scale = tables(C + 1, 30)
    q = torch.randn((1025, 30), device=cuda_device, generator=gen)
    cur, clamped = _ring_curs(gen, cuda_device, 1024, C)
    views = (q[1:], codes[1:], scale[1:])
    for metric in METRICS:
        got = int4_frontier.int4_frontier_scores(cur, *views, metric=metric)
        assert not int4_frontier.LAST_PLAN.bulk
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, int4_frontier.int4_frontier_scores_plain(
                clamped, *views, metric=metric),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [5, 13, 64])
def test_int8_ring_matches_plain_on_the_card(cuda_device, r):
    """The persistent ring at B = 1, 7, 1024 and 5000, D = 30, 40, 100,
    128, L2/IP/cosine, over every byte value (-128 included), zero scales,
    a zero query, repeated and out-of-range rows: within rtol = atol =
    1e-5, in the bulk branch where R % 4 == 0 and the vector branch
    otherwise (R = 13, D = 30: 390-byte code blocks copied byte by byte),
    and for views of the three tables off their 16-byte boundaries."""
    gen = torch.Generator(device=cuda_device).manual_seed(r)
    C = 512

    def tables(c, d):
        codes = torch.randint(-128, 128, (c, r, d), dtype=torch.int8,
                              device=cuda_device, generator=gen)
        scale = 0.005 * torch.rand((c, r), device=cuda_device, generator=gen)
        scale[:, ::4] = 0.0  # empty edge slots
        return codes, scale

    for d in (30, 40, 100, 128):
        codes, scale = tables(C, d)
        for b in (1, 7, 1024, 5000):
            q = 0.3 * torch.randn((b, d), device=cuda_device, generator=gen)
            q[0] = 0.0  # zero query: cosine 1.0
            cur, clamped = _ring_curs(gen, cuda_device, b, C)
            for metric in METRICS:
                got = int8_frontier.int8_frontier_scores(
                    cur, q, codes, scale, metric=metric)
                plan = int8_frontier.LAST_PLAN
                want = int8_frontier.int8_frontier_scores_plain(
                    clamped, q, codes, scale, metric=metric)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                           msg=f"{d} {b} {metric} {plan}")
            assert plan.bulk == (r % 4 == 0)
    # codes[1:] starts 150 bytes in, scale[1:] 20 bytes, q[1:] 120 bytes.
    codes, scale = tables(C + 1, 30)
    codes = codes[:, :5].contiguous()
    scale = scale[:, :5].contiguous()
    q = 0.3 * torch.randn((1025, 30), device=cuda_device, generator=gen)
    cur, clamped = _ring_curs(gen, cuda_device, 1024, C)
    views = (q[1:], codes[1:], scale[1:])
    for metric in METRICS:
        got = int8_frontier.int8_frontier_scores(cur, *views, metric=metric)
        assert not int8_frontier.LAST_PLAN.bulk
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, int8_frontier.int8_frontier_scores_plain(
                clamped, *views, metric=metric),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("r,d", [(128, 3072), (64, 4096), (13, 12288)])
def test_int8_ring_in_pieces_matches_plain_on_the_card(cuda_device, r, d):
    """Nodes too large for two stages, scored in pieces of
    ``stage_rows(R, D)`` rows (R=128, D=3072: 4 x 32 rows, bulk; R=64,
    D=4096: 24+24+16, bulk; R=13, D=12288: 4+4+4+1, vector), at B = 1, 7
    and 1024, L2/IP/cosine, with repeated and out-of-range rows: within
    rtol = atol = 1e-5 of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(r * d)
    C = 64
    codes = torch.randint(-128, 128, (C, r, d), dtype=torch.int8,
                          device=cuda_device, generator=gen)
    scale = 0.002 * torch.rand((C, r), device=cuda_device, generator=gen)
    scale[:, ::4] = 0.0
    rows = int8_frontier.stage_rows(r, d)
    assert rows < r
    for b in (1, 7, 1024):
        q = 0.3 * torch.randn((b, d), device=cuda_device, generator=gen)
        q[0] = 0.0
        cur, clamped = _ring_curs(gen, cuda_device, b, C)
        for metric in METRICS:
            got = int8_frontier.int8_frontier_scores(cur, q, codes, scale,
                                                     metric=metric)
            plan = int8_frontier.LAST_PLAN
            assert plan.stage_bytes == int8_frontier.stage_bytes(rows, d)
            assert plan.bulk == (r % 4 == 0)
            want = int8_frontier.int8_frontier_scores_plain(
                clamped, q, codes, scale, metric=metric)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=f"{b} {metric} {plan}")


@pytest.mark.cuda
def test_train_time_of_an_empty_kernel_is_below_its_lone_call_time(
        cuda_device):
    """A train of back-to-back calls charges each call the gap between two
    kernels, not the events' cost around a lone call."""
    from duckdb_lm_diskann_tpu_torch.utils import cuda_timing

    def empty(i):
        torch.cuda._sleep(0)

    for i in range(3):
        empty(i)
    lone = float(np.median(cuda_timing.device_ms(empty, 20)))
    train = cuda_timing.device_ms_train(empty, 20)
    assert 0.0 < train < lone, (train, lone)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_profile_hop():
    """benchmarks/profile_hop.py as a module, with the process state its
    import changes (the JAX compilation cache directory, sys.path) put
    back, and the Pallas globals that only its gather_ab() assigns set."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    cache_dir = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_profile_hop_reference", os.path.join(_REPO, "benchmarks", "profile_hop.py")
    )
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    mod.pl, mod.pltpu = pl, pltpu
    return mod


def _gather_tables(rng, C=64, widths=(40,)):
    tables = [
        rng.integers(0, 2**32, (C, w), dtype=np.uint64).astype(np.uint32)
        for w in widths
    ]
    idx = rng.integers(0, C, 12).astype(np.int32)
    idx[3] = idx[4] = idx[9] = idx[0]  # repeated rows
    idx[5], idx[6] = 0, C - 1
    return idx, tables


def test_row_gather_plain_matches_jax(rng):
    """One table (C=64, X=40) and four SoA tables (widths 16/8/8/32) with
    repeated rows: the plain version equals the hop profiler's Pallas
    kernels (interpret mode, K = 2 and 8), and so does the wrapper on CPU
    tensors, which launches nothing."""
    import jax.numpy as jnp

    ref = _jax_profile_hop()
    idx, (src,) = _gather_tables(rng)
    got = row_gather.pipelined_gather_plain(
        torch.from_numpy(idx), torch.from_numpy(src.view(np.int32))
    )
    idx4, tabs4 = _gather_tables(rng, widths=(16, 8, 8, 32))
    t4 = [torch.from_numpy(t.view(np.int32)) for t in tabs4]
    got4 = [row_gather.pipelined_gather_plain(torch.from_numpy(idx4), t)
            for t in t4]
    for k in (2, 8):
        want = ref._pipelined_gather(
            jnp.asarray(idx), jnp.asarray(src), n_flight=k, interpret=True
        )
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
        want4 = ref._pipelined_gather4(
            jnp.asarray(idx4), [jnp.asarray(t) for t in tabs4], n_flight=k,
            interpret=True,
        )
        for g, w in zip(got4, want4):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    before = (row_gather.LAUNCHES, row_gather.LAUNCHES4)
    assert torch.equal(
        row_gather.pipelined_gather(
            torch.from_numpy(idx), torch.from_numpy(src.view(np.int32))
        ),
        got,
    )
    for g, w in zip(row_gather.pipelined_gather4(torch.from_numpy(idx4), t4), got4):
        assert torch.equal(g, w)
    assert (row_gather.LAUNCHES, row_gather.LAUNCHES4) == before


def test_row_gather_clamps_and_rejects(rng):
    src = torch.arange(5 * 3, dtype=torch.int32).reshape(5, 3)
    idx = torch.tensor([-4, 0, 4, 9], dtype=torch.int32)
    got = row_gather.pipelined_gather(idx, src)
    assert got[:, 0].tolist() == [0, 0, 12, 12]  # rows 0, 0, 4, 4
    with pytest.raises(ValueError, match="n_flight"):
        row_gather.pipelined_gather(idx, src, n_flight=3)
    with pytest.raises(ValueError, match="idx must be"):
        row_gather.pipelined_gather(idx.long(), src)
    with pytest.raises(ValueError, match="differ in rows"):
        row_gather.pipelined_gather4(idx, (src, src, src, src[:4]))
    with pytest.raises(ValueError, match="four tables"):
        row_gather.pipelined_gather4(idx, (src, src))
    with pytest.raises(ValueError, match="empty"):
        row_gather.pipelined_gather(idx, src[:0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_flight", row_gather.N_FLIGHT)
def test_row_gather_kernel_equals_plain_on_the_card(cuda_device, n_flight):
    """Exactly equal, at B = 1, 7, 1024 and 5000: the 16-byte path
    (X = 1280, 40, and the four SoA tables in one launch) and the 4-byte
    path (X = 130, a ragged width, and table views 4 bytes off a 16-byte
    boundary), with repeated and out-of-range rows; and rows above 2^21 of
    a 1280-word table in both paths (64-bit offsets: row * X passes 2^31).
    Each launch counts once, on its entry point's counter."""
    gen = torch.Generator(device=cuda_device).manual_seed(n_flight)

    def rand(shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                             device=cuda_device, generator=gen)

    def misaligned(t):  # the same shape, one word off 16 bytes
        flat = torch.empty(t.numel() + 1, dtype=torch.int32,
                           device=cuda_device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    def check(idx, tables, vec):
        if len(tables) == 1:
            got = [row_gather.pipelined_gather(idx, tables[0], n_flight)]
        else:
            got = row_gather.pipelined_gather4(idx, tables, n_flight)
        torch.cuda.synchronize()
        assert all(row_gather.LAST_PLAN.vec) == vec
        for g, t in zip(got, tables):
            assert torch.equal(g, row_gather.pipelined_gather_plain(idx, t))

    before = (row_gather.LAUNCHES, row_gather.LAUNCHES4)
    for b in (1, 7, 1024, 5000):
        idx = torch.randint(0, 4096, (b,), dtype=torch.int32,
                            device=cuda_device, generator=gen)
        idx[1::7] = idx[0]
        idx[2:3] = -5
        idx[3:4] = 10**6
        for x, vec in ((1280, True), (40, True), (130, False)):
            check(idx, [rand((4096, x))], vec)
        check(idx, [misaligned(rand((4096, 1280)))], False)
        tabs = [rand((4096, x)) for x in (128, 64, 64, 1024)]
        check(idx, tabs, True)
        tabs[3] = misaligned(tabs[3])
        check(idx, tabs, False)
    # Rows past 2^21 of a 1280-word table: only the gathered rows are set.
    big = torch.empty(((1 << 21) + 4096, 1280), dtype=torch.int32,
                      device=cuda_device)
    hi = torch.randint(1 << 21, big.shape[0] - 1, (300,), dtype=torch.int32,
                       device=cuda_device, generator=gen)
    big[hi.long()] = rand((300, 1280))
    big[hi.long() + 1] = rand((300, 1280))
    check(hi, [big], True)
    check(hi, [big.view(-1)[1 : 1 + (big.shape[0] - 1) * 1280].view(-1, 1280)],
          False)
    assert (row_gather.LAUNCHES, row_gather.LAUNCHES4) == (
        before[0] + 4 * 4 + 2, before[1] + 4 * 2
    )
