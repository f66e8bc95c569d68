"""A module-scoped autouse fixture for the port's CPU tests: PyTorch on one
intra-op thread while the module runs, the old count restored after.

The suite runs several xdist workers on the CPU at once; a pool of one
thread per core in each of them oversubscribes the cores and stalls the
port's CPU steps many times over. A test module takes the fixture by
importing it: ``from tests._torch_threads import one_thread``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
