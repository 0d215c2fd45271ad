"""One intra-op thread for the port's CPU parity tests.

The port's tests run many small PyTorch operations at ``reduced()`` sizes.
With PyTorch's default of one intra-op thread per core, every parallel
region waits at a barrier for all of its threads; when the test workers
(and anything else on the machine) already use every core, those threads
are descheduled and a test that takes half a second alone takes a minute.
On one thread the operations run the same kernels without the barrier.

Import the fixture into a test module to use it there (it is autouse and
module-scoped, and restores the thread count when the module ends)::

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
