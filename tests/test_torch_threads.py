"""One torch thread for the port's CPU tests.

The port's tests run tiny tensors (case9, a few hundred lanes) through
hundreds of small PyTorch ops per inner iteration. Such ops gain nothing
from torch's intra-op threads, and with several test workers on one machine
those threads only contend: a case9 multi-period solve ran about 7x slower
with the default thread count than with one thread under six parallel
workers. Import ``one_torch_thread`` into a test module to run its tests
(and its module fixtures) with one thread; the count is restored after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_in_effect():
    assert torch.get_num_threads() == 1
