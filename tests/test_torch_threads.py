"""A fixture that runs a test module's port on few CPU threads.

The suite runs several worker processes on the machine's cores; torch's
intra-op threads, one a core in every worker, then spin at their barriers
against each other (a bf16 DeepLabV3 step of 0.7 s alone took 38 s in a
full run). A module opts in with::

    from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

    pytestmark = pytest.mark.usefixtures("few_torch_threads")

and its tolerances must hold at ``TORCH_THREADS`` threads (a sum's order
follows the thread count).
"""

import contextlib

import pytest
import torch

TORCH_THREADS = 2


@contextlib.contextmanager
def torch_threads(n: int):
    """``n`` torch intra-op threads inside, the count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def few_torch_threads():
    """``TORCH_THREADS`` for the module's tests."""
    with torch_threads(TORCH_THREADS):
        yield


def test_torch_threads_sets_and_restores_the_count():
    before = torch.get_num_threads()
    with pytest.raises(ValueError, match="inside"):
        with torch_threads(1):
            assert torch.get_num_threads() == 1
            raise ValueError("inside")
    assert torch.get_num_threads() == before
