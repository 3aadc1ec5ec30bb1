"""One thread for each compute pool a port test module drives: torch's
intra-op pool and the BLAS and OpenMP pools of the libraries loaded in the
process (numpy's and scipy's OpenBLAS among them, through threadpoolctl
where it is installed).

The suite runs its files in several worker processes at once; a worker
whose torch or BLAS calls each start a thread per core fights the others
for the cores (minutes a test instead of seconds). Each port test file
holds its tests under ``one_thread()`` by importing the module-scoped
autouse fixture ``_one_thread``. threadpoolctl is optional: without it
(the card's machine need not have it) only torch is pinned.
"""

import contextlib

import numpy  # noqa: F401  (its BLAS loaded before the limit is set)
import pytest
import torch

try:
    import scipy.linalg  # noqa: F401  (scipy's own BLAS, likewise)
except ImportError:
    pass

try:
    import threadpoolctl
except ImportError:
    threadpoolctl = None


@contextlib.contextmanager
def one_thread():
    """torch's intra-op threads and every loaded BLAS / OpenMP pool at one
    thread inside the block, restored after it."""
    n = torch.get_num_threads()
    limits = (threadpoolctl.threadpool_limits(limits=1)
              if threadpoolctl is not None else contextlib.nullcontext())
    torch.set_num_threads(1)
    try:
        with limits:
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread for the tests of the module that
    imports this fixture (``from port_threads import _one_thread``)."""
    with one_thread():
        yield
