"""The float32 flash forward's arithmetic (3xTF32, online softmax over key
tiles) emulated in torch, at head dim 64: the TF32 cases of
``test_torch_flash_attention.py`` (which holds the emulation and the
reasons for its limits), in a file of their own so that the test runner
spreads them over its workers."""
import pytest

import test_torch_flash_attention as fa
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

D = 64


def test_tf32_rounds_to_nearest_even():
    fa._tf32_rounds_to_nearest_even()


@pytest.mark.parametrize("causal", [True, False])
def test_tf32_kernel_arithmetic_matches_pallas_interpret(causal):
    fa._tf32_kernel_arithmetic_matches_pallas_interpret(D, causal)


@pytest.mark.parametrize("s", [77, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32_kernel_arithmetic_matches_references_ragged(s, causal):
    fa._tf32_kernel_arithmetic_matches_references_ragged(s, D, causal)


def test_single_tf32_product_fails_the_float32_limit():
    fa._single_tf32_product_fails_the_float32_limit()


@pytest.mark.parametrize("nan_bits", [0x7FFFFFFF, -1, 0x7FC00000])
def test_tf32_kernel_arithmetic_propagates_nan(nan_bits):
    fa._tf32_kernel_arithmetic_propagates_nan(D, nan_bits)
