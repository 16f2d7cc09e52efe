"""One intra-op thread for the port's CPU parity tests.

The tests' tensors are small and the suite runs several worker
processes on a few cores: PyTorch's default of one thread a core then
oversubscribes the machine, and its spinning threads make a test many
times slower than it is alone.  With one thread it is faster even
alone.  A test module opts in by importing the fixture.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
