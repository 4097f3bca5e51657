"""Shared fixtures of the PyTorch port's tests. Import them into a test
module to apply them there.

``one_torch_thread``: the port's CPU tests run many small tensor ops. With
torch's default of one intra-op thread per core, several pytest-xdist
workers oversubscribe the cores and every small op pays for it; one thread
per worker is faster here and leaves the cores to the other workers.

``jax_map_budget``: XLA:CPU keeps each compiled program's code in memory
maps of its own for as long as JAX's caches hold the program. A worker
that runs the JAX side of many parity tests piles them up (four port test
files leave ~38,000) until the process reaches the kernel's limit
(``vm.max_map_count``, 65,530 by default); XLA then crashes in its next
compile or compile-cache read or write, and the worker dies with the test
it was running. Before and after each test, while the process holds more
than ``MAP_BUDGET`` maps, the fixture drops JAX's caches, which frees them
(later tests reload their programs from the persistent compile cache).
"""

import gc

import pytest
import torch

MAP_BUDGET = 10_000


def map_count() -> int:
    """Memory maps of this process (0 where there is no procfs)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def _drop_jax_programs_over_budget() -> None:
    if map_count() > MAP_BUDGET:
        import jax

        jax.clear_caches()
        gc.collect()


@pytest.fixture(autouse=True)
def jax_map_budget():
    _drop_jax_programs_over_budget()
    yield
    _drop_jax_programs_over_budget()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
