"""The flash backward's plain version at the bf16 kernels' tile edges (S
one below, at and one above each 64-row tile and 128-row block), head dim
128: the cases of ``test_torch_flash_attention_bwd.py``'s
``_tile_edge_case`` against ``jax.vjp`` of the reference's
``_mha_reference``, in a file of their own so that the test runner spreads
them over its workers."""
import pytest

import test_torch_flash_attention_bwd as fb

D = 128


@pytest.mark.parametrize("s", fb.TILE_EDGE_S)
@pytest.mark.parametrize("causal", [True, False])
def test_tile_edges_match_vjp_of_mha_reference(s, causal):
    fb._tile_edge_case(s, s, D, causal, seed=s * 5 + D + causal)
