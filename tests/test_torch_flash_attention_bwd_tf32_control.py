"""The float32 backward pair's emulation (``test_torch_flash_attention_bwd.
py``) at D=64: with an lse cotangent against the reference's ``_mha_bwd``
in interpret mode, and the control that one TF32 product (hi hi) fails the
float32 limit where three pass. A file of its own, so that the test runner
spreads the TF32 cases over its workers."""
import test_torch_flash_attention_bwd as fb
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


def test_tf32_bwd_arithmetic_with_lse_cotangent():
    fb._tf32_bwd_arithmetic_with_lse_cotangent()


def test_single_tf32_product_fails_the_float32_backward_limit():
    fb._single_tf32_product_fails_the_float32_backward_limit()


def test_tf32_bwd_cancelling_dq_keeps_float32_accuracy():
    fb._tf32_bwd_cancelling_dq_keeps_float32_accuracy()
