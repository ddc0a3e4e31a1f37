"""One torch intra-op thread for a test module of the port on the CPU.

The suite runs in several worker processes at once, one on each of most
of the cores. The port's tests run many small torch ops, and at torch's
default each op takes a team of as many threads as there are cores,
which then wait for cores the other workers hold: a module takes 4-8
times its time alone. A module that imports the fixture runs on one
thread, restored after it:

    from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
