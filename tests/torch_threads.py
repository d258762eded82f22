"""The module fixture that runs a test file's torch ops on one intra-op
thread.

Under pytest-xdist's workers each process would otherwise spin up a torch
thread per core, and the many small ops of the parity tests (fixture
stylizes at 32-64px, k-means steps, interpret-mode kernels beside them)
then run 5-300x slower than alone. A file takes it with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module, the old count after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
