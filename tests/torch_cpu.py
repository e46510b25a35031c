"""Shared set-up of the PyTorch port's CPU tests (``test_torch_*.py``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run each port test module on one PyTorch intra-op thread.  The
    tests work on small tensors, where the threads' hand-offs cost more
    than they give, most of all when several test processes share the
    cores; each module gets the process's setting back when it ends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
