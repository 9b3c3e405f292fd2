"""The one-thread fixture of the port's test files (torch only: the card
tests import it too).  Each ``tests/test_torch_*.py`` imports it:

    from _torch_threads import _one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the suite runs in several worker processes on a
    few cores, where the port's many small CPU ops slow down by an order
    of magnitude when every process also starts a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
