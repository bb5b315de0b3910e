"""The test helper that runs the port's heaviest test modules at two
torch intra-op threads (``tests/torch_threads.py``) sets the count inside
and gives the caller's count back after."""
import torch

from torch_threads import intra_op_threads


def test_two_intra_op_threads_inside_and_the_count_restored_after():
    before = torch.get_num_threads()
    with intra_op_threads(2):
        assert torch.get_num_threads() == 2
    assert torch.get_num_threads() == before
