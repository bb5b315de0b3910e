"""Two intra-op threads for torch in the port's heaviest test modules.

The suite runs under xdist, six worker processes on an 8-core host, and
torch's default intra-op pool (a thread a core in each process) then asks
for six times the host's cores: small CPU ops spin-wait on the others'
threads. A test module that imports ``two_intra_op_threads`` (an autouse,
module-scoped fixture) runs its tests at two threads and gives the count
back after its last test; the modules that do are the ones that took most
of the port's test time at torch's default (the float32 kernels'
emulations, ResNet's, the models' and the engines' parity files).
"""
import contextlib

import pytest
import torch


@contextlib.contextmanager
def intra_op_threads(n: int):
    """torch's intra-op thread count set to ``n`` inside, the caller's
    count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def two_intra_op_threads():
    with intra_op_threads(2):
        yield
