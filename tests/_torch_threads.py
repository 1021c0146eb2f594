"""One intra-op thread for torch while a test module runs.

The port's CPU tests compute on small tensors, where torch's intra-op
threads only add their start-up and wait; and under ``pytest -n 6`` the
workers' threads (one a core each, by default) contend for the same
cores, which made such a module run many times slower than alone.  A
module imports ``one_torch_thread`` to use it; the previous count comes
back when the module ends.  Results do not depend on it beyond the order
of floating-point sums, which every test's tolerance already covers."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
