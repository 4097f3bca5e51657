"""Shared fixture of the PyTorch port's tests.

The port's CPU tests run many small tensor ops. With torch's default of one
intra-op thread per core, several pytest-xdist workers oversubscribe the
cores and every small op pays for it; one thread per worker is faster here
and leaves the cores to the other workers. Import the fixture into a test
module to apply it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
