"""The PyTorch port imports no JAX, nothing of the JAX package and not
``bench.py``: it keeps its own copies of the host modules it needs.

Checked in a fresh interpreter: this test process already holds jax (the
JAX package's tests import it), so ``sys.modules`` here proves nothing.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import duckdb_lm_diskann_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "bench", "duckdb_lm_diskann_tpu")
)
assert not leaked, leaked
# Importing builds nothing: the native block store loads at first use.
assert sys.modules[pkg.__name__ + ".store.file_service"]._lib is None
print(" ".join(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK],
        cwd=_REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    # cli, common (1), core (5), db (6), experiments (15), kernels (5),
    # ops (4), parallel (4), store (4), utils (5) and the nine subpackages
    # themselves.
    assert len(names) >= 59, names
    pkg = "duckdb_lm_diskann_tpu_torch."
    for mod in (
        "experiments.profile_hop", "experiments.profile_delete",
        "utils.roofline", "utils.verify", "kernels.row_gather",
        "store.block_codec", "store.file_service", "store.shadow",
        "store.checkpoint", "db.settings", "db.functions", "db.index",
        "db.planner", "db.database", "db.sqltest", "cli",
        "parallel.mesh", "parallel.sharded", "parallel.global_graph",
        "parallel.multihost", "experiments.profile_real",
        "experiments.profile_searcher", "experiments.profile_insert",
        "experiments.ab_stream", "experiments.ab_hard_recall",
        "experiments.ab_insert_width", "experiments.ab_width_iso",
        "experiments.ab_hard_build", "experiments.paper_scale_gist1m",
        "experiments.ab_int4_layout",
    ):
        assert pkg + mod in names
