"""One intra-op torch thread for a test module of small tensors.

The suite's workers share the machine's cores.  A torch pool of one thread
per core then waits at every op for threads the OS has descheduled: the
FL and example tests ran 14x slower so (a 3-test file, 159 s against 11.5
s on 8 busy cores).  The pool size is restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
