"""The float32 flash backward pair's arithmetic (dq_tf32_kernel and
dkv_tf32_kernel) emulated in torch, at head dim 64: the TF32 cases of
``test_torch_flash_attention_bwd.py`` (which holds the emulation and the
reasons for its limits), in a file of their own so that the test runner
spreads them over its workers."""
import pytest

import test_torch_flash_attention_bwd as fb
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

D = 64


@pytest.mark.parametrize("causal", [True, False])
def test_tf32_bwd_arithmetic_matches_pallas_interpret(causal):
    fb._tf32_bwd_arithmetic_matches_pallas_interpret(D, causal)


@pytest.mark.parametrize("sq,sk,causal", [(77, 77, True), (300, 300, True),
                                          (300, 300, False),
                                          (100, 300, False),
                                          (129, 65, False)])
def test_tf32_bwd_arithmetic_matches_references_ragged(sq, sk, causal):
    fb._tf32_bwd_arithmetic_matches_references_ragged(sq, sk, causal, D)


@pytest.mark.parametrize("nan_bits", [0x7FFFFFFF, 0x7FC00000])
def test_tf32_bwd_arithmetic_propagates_nan_in_do(nan_bits):
    fb._tf32_bwd_arithmetic_propagates_nan_in_do(D, nan_bits)
