"""The PyTorch port imports no JAX.

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
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not leaked, leaked
print(len(names))
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
    # ops (3), kernels (1), core (4) and the subpackages themselves.
    assert int(proc.stdout.strip()) >= 11, proc.stdout
