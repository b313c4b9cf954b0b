"""One torch intra-op thread while a port test module runs.

The Tier-1 command runs the suite in several worker processes on one
machine. Each torch process starts as many intra-op threads as the
machine has cores, so the workers' thread pools oversubscribe the cores
and the many small tensor ops of the port's CPU tests wait on one
another: tests/test_torch_offline.py, ~27 s alone, took 735 s in a
six-worker run on 8 cores; three of its tests took 183 s beside six
busy processes at the default count and 19 s at one thread. The port's
test modules import `one_torch_thread`, an autouse fixture that sets
one thread for the module and restores the count after it. Results are
held to the same bounds either way.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
