"""``one_torch_thread``: a module-scoped autouse fixture for the port's CPU
tests, imported by the test modules that use it (no JAX here, so a module
without JAX stays without it)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch ops on one thread while the module runs. The test workers share
    the machine's cores, and a torch thread pool as wide as the machine in
    each of them spins against the others': six workers ran one of these
    files 7× slower with it than on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
