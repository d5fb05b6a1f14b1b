"""The thread policy of the port's CPU tests.

The suite runs in several worker processes at once, and each would start
as many intra-op threads as the machine has cores; the plain version runs
many small tensor ops, for which those threads fight each other for the
cores and cost far more than they give. So every port test module imports
the fixture (``from torch_threads import one_thread  # noqa: F401``;
pytest registers a fixture imported into a test module), and every Python
subprocess a port test starts takes :func:`one_thread_env` as its
environment, since a subprocess does not inherit ``torch.set_num_threads``.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tests, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def one_thread_env(**extra) -> dict:
    """The environment of a test's subprocess: this one's, with one OpenMP
    thread (PyTorch's intra-op pool reads it) and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)
