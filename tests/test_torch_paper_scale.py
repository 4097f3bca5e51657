"""The twins of ``tests/test_paper_scale.py`` for the PyTorch port: a 960-d
cosine TERNARY graph served from eight row blocks, and the memory of the
full GIST1M graph split eight ways.

The capacity claim is counted on the ``meta`` device here (no 19.5 GB
allocation on the CPU); its ``cuda`` twin allocates the eight blocks on
the card and skips without one.
"""

import json

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.experiments import paper_scale_gist1m
from duckdb_lm_diskann_tpu_torch.parallel.global_graph import (
    GlobalShardedIndex,
)
from duckdb_lm_diskann_tpu_torch.parallel.mesh import make_mesh
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)


def test_gist1m_capacity_counted_on_meta():
    """2^20 rows, R = 64, 960-d TERNARY in eight row blocks, counted: the
    JAX test's memory model (~19.5 kB a row, over 16 GB in all, under 3 GB
    a block)."""
    res = paper_scale_gist1m.capacity("meta")
    assert res["bytes_per_row"] == 3840 + 2 * 64 * 30 * 4 + 64 * 4 + 2
    paper_scale_gist1m.check_memory_model(res)


@pytest.mark.cuda
def test_gist1m_capacity_allocation_on_the_card():
    """The same eight blocks allocated on the card for real."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = paper_scale_gist1m.capacity("cuda")
    paper_scale_gist1m.check_memory_model(res)
    assert res == paper_scale_gist1m.capacity("meta")
    torch.cuda.empty_cache()


def test_gist_960d_sharded_recall(rng):
    """Build a 960-d cosine TERNARY graph, serve it from eight row blocks
    (``make_mesh("cpu", 8)``): every block holds total / 8 of every
    non-empty table, recall@10 >= 0.93 against brute force, and the
    blocks' answer equals the single Coordinator's."""
    cfg = paper_scale_gist1m.gist_config(r=32)  # L_insert 64
    n, d = 1024, 960
    z = rng.standard_normal((n, 24)).astype(np.float32)
    w = (rng.standard_normal((24, d)) / 5).astype(np.float32)
    data = np.tanh(z @ w) + 0.02 * rng.standard_normal((n, d)).astype(
        np.float32)
    coord = Coordinator(cfg, initial_capacity=n, device="cpu")
    coord.bulk_build(list(range(n)), data, max_batch=256)

    gidx = GlobalShardedIndex(coord, mesh=make_mesh("cpu", 8))
    sizes = paper_scale_gist1m.block_bytes(gidx.distribute())
    assert sizes["total"] == sum(
        t.numel() * t.element_size() for t in coord.arrays)
    assert all(b * 8 == sizes["total"] for b in sizes["per_block"])

    q = data[:128] + 0.01 * rng.standard_normal((128, d)).astype(np.float32)
    ids, dists = gidx.search(q, 10, l_search=128)
    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ dn.T), axis=1)[:, :10]
    hits = sum(len(set(a) & set(b))
               for a, b in zip(ids.tolist(), truth.tolist()))
    assert hits / (len(q) * 10) >= 0.93

    ids_1, d_1 = coord.search(q, 10, l_search=128)
    np.testing.assert_array_equal(ids, ids_1)
    np.testing.assert_array_equal(dists, d_1)


def test_paper_scale_run_keeps_the_coordinator_tables_empty():
    """``run`` at a small size on eight CPU blocks: the Coordinator's own
    tables stay empty, every block holds 1/8, the answer is exact."""
    res = paper_scale_gist1m.run(256, max_batch=64, r=8, device="cpu",
                                 n_queries=16)
    assert res["graph_bytes_total"] == 8 * res["graph_bytes_per_block"][0]
    assert res["recall_at_10_l100"] >= 0.9
    assert res["hops"] > 0
    q, v = res["queries"].astype(np.float64), res["data"][res["ids"]]
    cos = (q[:, None, :] * v).sum(-1) / (
        np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(v, axis=-1))
    np.testing.assert_allclose(res["dists"], 1.0 - cos, atol=1e-5)


def test_paper_scale_main_writes_its_json_to_out(tmp_path, capsys):
    """``python -m ...paper_scale_gist1m 256 64 8 --device cpu --out F``:
    the numbers go to standard output and to F, and nowhere else."""
    out = tmp_path / "gist.json"
    assert paper_scale_gist1m.main(
        ["256", "64", "8", "--device", "cpu", "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed
    assert printed["n"] == 256 and printed["r"] == 8
    assert printed["graph_bytes_total"] == 8 * printed[
        "graph_bytes_per_block"][0]
    assert list(tmp_path.iterdir()) == [out]
