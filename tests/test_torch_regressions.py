"""The twins of three ``tests/test_regressions.py`` cases for the PyTorch
port (the others have theirs in ``test_torch_persistence.py``,
``test_torch_lifecycle.py`` and ``test_torch_snapshot.py``):

  * reopening a persisted index with conflicting layout options raises,
    and options left unspecified take the persisted values;
  * row ids >= 2^40 survive ``ShardedIndex`` as int64;
  * a row id listed twice in one delete batch is deleted once.
"""

import numpy as np
import pytest

from duckdb_lm_diskann_tpu_torch.common.types import MetricType, VectorType
from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.db.database import connect
from duckdb_lm_diskann_tpu_torch.parallel.mesh import make_mesh
from duckdb_lm_diskann_tpu_torch.parallel.sharded import ShardedIndex
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

OPTS = {"metric": "cosine", "r": 4, "l_insert": 8, "l_search": 16}


def test_reopen_conflicting_layout_options_raise(tmp_path, rng):
    data = rng.standard_normal((48, 8)).astype(np.float32)
    db = connect(str(tmp_path / "db"), device="cpu")
    t = db.create_table("t", {"v": data})
    db.create_index("idx", t, "v", options=dict(OPTS))
    db.checkpoint()

    db2 = connect(str(tmp_path / "db"), device="cpu")
    t2 = db2.create_table("t", {"v": data})
    bad = dict(OPTS, r=8)  # the persisted index has r = 4
    with pytest.raises(ValueError, match="conflicts with the persisted"):
        db2.create_index("idx", t2, "v", options=bad)
    db3 = connect(str(tmp_path / "db"), device="cpu")
    t3 = db3.create_table("t", {"v": data})
    idx3 = db3.create_index("idx", t3, "v")
    assert idx3.config.r == 4
    assert idx3.config.metric_type is MetricType.COSINE


def test_sharded_search_preserves_int64_rowids(rng):
    dims, n, k = 8, 120, 3
    cfg = LmDiskannConfig(
        metric_type=MetricType.COSINE, r=4, l_insert=8, l_search=24,
        dimensions=dims, node_vector_type=VectorType.FLOAT32,
    )
    data = rng.standard_normal((n, dims)).astype(np.float32)
    rowids = (1 << 40) + 7 + np.arange(n, dtype=np.int64)
    idx = ShardedIndex(cfg, mesh=make_mesh("cpu", 4))
    idx.build(rowids, data)
    ids, _ = idx.search(data[:6], k)
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids[:, 0], rowids[:6])


def test_delete_with_duplicate_rowids_in_one_batch(rng):
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=4, l_insert=8, l_search=16,
        dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    cfg.validate()
    coord = Coordinator(cfg, device="cpu")
    data = rng.standard_normal((40, 8)).astype(np.float32)
    coord.bulk_build(list(range(40)), data)
    assert coord.delete([3, 7, 3, 11, 7, 3]) == 3
    assert coord.count == 37
    ids, _ = coord.search(data[:1], 5, l_search=16)
    assert not {3, 7, 11} & set(ids.ravel().tolist())
