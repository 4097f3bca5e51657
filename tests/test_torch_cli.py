"""The PyTorch port's CLI (build / search / bench / info / compact /
verify), in-process with ``--device cpu``: the cases of
``tests/test_cli.py``, plus the default device and ``bench --out``."""

import json

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.cli import main
from tests.test_torch_sql import clustered_data
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

CPU = ["--device", "cpu"]


@pytest.fixture
def built_index(tmp_path, rng, capsys):
    data = clustered_data(rng, 200, 16, n_clusters=10)
    vec_path = tmp_path / "vecs.npy"
    np.save(vec_path, data)
    db = str(tmp_path / "db")
    rc = main([
        "build", "--db", db, "--index", "idx", "--vectors", str(vec_path),
        "--metric", "l2", "--r", "8", "--l-insert", "16", "--l-search", "32",
        *CPU,
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["built"] == 200
    return db, data, tmp_path


def test_cli_search(built_index):
    db, data, tmp_path = built_index
    q_path, out_path = tmp_path / "q.npy", tmp_path / "res.npy"
    np.save(q_path, data[:4])
    rc = main([
        "search", "--db", db, "--index", "idx", "--queries", str(q_path),
        "--k", "5", "--out", str(out_path), *CPU,
    ])
    assert rc == 0
    ids = np.load(out_path)
    assert ids.shape == (4, 5)
    assert np.load(tmp_path / "res_dists.npy").shape == (4, 5)
    assert (ids[:, 0] == np.arange(4)).sum() >= 3


def test_cli_bench(built_index, capsys):
    """Recall against the index's own live rows, a ragged last batch (33
    queries in batches of 16), and the result ids saved with --out."""
    db, data, tmp_path = built_index
    q_path = tmp_path / "q.npy"
    np.save(q_path, data[:33])
    rc = main([
        "bench", "--db", db, "--index", "idx", "--queries", str(q_path),
        "--k", "5", "--l-search", "64", "--batch", "16",
        "--out", str(tmp_path / "ids.npy"), *CPU,
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["queries"] == 33 and out["qps"] > 0 and out["device"] == "cpu"
    assert out["recall_at_k"] >= 0.9
    assert out["p50_batch_ms"] <= out["p99_batch_ms"]
    ids = np.load(tmp_path / "ids.npy")
    assert ids.shape == (33, 5) and (ids[:, 0] == np.arange(33)).sum() >= 30


def test_cli_build_edge_type(tmp_path, rng, capsys):
    data = clustered_data(rng, 100, 16, n_clusters=5)
    vec_path = tmp_path / "vecs.npy"
    np.save(vec_path, data)
    db = str(tmp_path / "db")
    rc = main([
        "build", "--db", db, "--index", "idx", "--vectors", str(vec_path),
        "--metric", "cosine", "--r", "8", "--l-insert", "16",
        "--edge-type", "float1bit", *CPU,
    ])
    assert rc == 0
    capsys.readouterr()
    assert main(["info", "--db", db, "--index", "idx", *CPU]) == 0
    assert json.loads(capsys.readouterr().out)["edge_type"] == "float1bit"


def test_cli_info_compact_verify(built_index, capsys):
    db, _, _ = built_index
    assert main(["info", "--db", db, "--index", "idx", *CPU]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["count"] == 200 and info["metric"] == "l2"
    assert main(["verify", "--db", db, "--index", "idx", *CPU]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert main(["compact", "--db", db, "--index", "idx", *CPU]) == 0
    assert json.loads(capsys.readouterr().out)["recycled_slots"] == 0


def test_cli_device_defaults_to_the_card(built_index, monkeypatch):
    """Without --device every command asks for the card; without one the
    Coordinator refuses rather than falling back to the CPU."""
    import torch

    db, _, _ = built_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["info", "--db", db, "--index", "idx"])
