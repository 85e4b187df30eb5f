"""The setting every port test module runs in.  Each ``test_torch_*.py``
that runs on the CPU imports ``port_module`` from here; importing it sets
torch to one thread, and the fixture, autouse and module-scoped, runs the
module's tests in inference mode with the BLAS libraries on one thread.

Nothing in these tests is differentiated, so inference mode saves
autograd's per-operation bookkeeping.  The JAX references reach LAPACK
through scipy's OpenBLAS, and numpy brings its own; each keeps a pool of
one thread per core whose threads spin while they wait for work.  The
suite runs its files in several worker processes on one host, so those
spinning pools take the cores that the other workers' files need.  The
fixture restores the pools' sizes when the module ends, so the JAX
package's own test modules run as they would without it."""

import contextlib

import pytest
import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS, see below)
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # without it, the pools keep their sizes
    threadpool_limits = None

torch.set_num_threads(1)


def _one_blas_thread():
    """JAX loads scipy's OpenBLAS at its first LAPACK call; the import of
    ``scipy.linalg`` above has loaded it already, so the limit reaches
    it."""
    if threadpool_limits is None:
        return contextlib.nullcontext()
    return threadpool_limits(limits=1, user_api="blas")


@pytest.fixture(autouse=True, scope="module")
def port_module():
    """Inference mode and one BLAS thread for the whole module."""
    with torch.inference_mode(), _one_blas_thread():
        yield
