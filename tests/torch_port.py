"""Shared set-up of the port's CPU tests (tests/test_torch_*.py).

The suite runs in several pytest-xdist workers at once, and by default
each worker's torch takes one intra-op thread per core: the workers then
oversubscribe the cores and the port's eager CPU forwards slow down by up
to 15x. Each port test module runs with one torch thread and gives the
previous count back when it ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
