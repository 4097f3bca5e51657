"""The control (the reference in TF32, in the program's place) comes out
not correct, at the cells' widths and a size a CPU test can hold. (The
fewer the rows, the farther the neighbors and the smaller TF32's relative
error: at 2,500 rows some 960-d seeds read under the limit; at 131,072
rows the cells read 8.3e-4 and more on the chip.)"""

import pytest

from lmdbench import control, judge, registry
from lmdbench.tests.tiny import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 9, 77])
def test_control_is_not_correct(name, seed):
    bench, cell, config, traffic = tiny(name, rows=20000)
    config["dims"] = registry.config(bench, cell["config"])["dims"]
    traffic["pool"] = 200
    numbers = control.control_numbers(config, traffic, seed, "cpu")
    checks = judge.checks(config, numbers)
    assert not all(judge.holds(c) for c in checks.values()), checks
    assert not judge.holds(checks["dist_rel_err"])
