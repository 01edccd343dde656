"""The port's CPU tests run torch on one thread.

Event loops, float64 recurrences, emulated kernels and smoke models are
thousands of small torch ops: with several test workers on one machine,
torch's intra-op threads only contend (a run 100x slower or worse). A
port test file binds the fixture under its own name, so that it applies
to every test in that file:

    from _torch_threads import one_thread as _one_thread  # noqa: F401
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run the module's tests on one torch thread; restore the count
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
