"""Port parity: the flash-attention forward's plain version
(paddle_tpu_torch/ops/cuda_attention.py::mha_fwd_reference, which CPU
tensors take through the kernel's wrapper) against the JAX package's Pallas
kernel ``pallas_attention.mha`` in interpret mode (out and lse) and against
``_mha_reference``, in float32 from seeded numpy. atol 1e-5: float32 sums in
another order. The kernel itself runs only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_attention import _mha_fwd, _mha_reference, mha
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops.flash_attention import attention_bshd, prefill_flash

B, H, D = 2, 2, 64
ATOL = 1e-5


def _qkv(s, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, H, D).astype(np.float32) for _ in range(3)]


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_out_and_lse_match_pallas_interpret(s, causal):
    q, k, v = _qkv(s, seed=s + causal)
    scale = 1.0 / np.sqrt(D)
    j_out = np.swapaxes(np.asarray(mha(_bhsd(q), _bhsd(k), _bhsd(v),
                                       causal, scale, 128, 128)), 1, 2)
    _, j_lse = _mha_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale, 128,
                        128)
    before = ca.plain_calls
    out, lse = ca.flash_attention_fwd(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal=causal,
                                      scale=scale)
    assert ca.plain_calls == before + 1
    assert out.shape == (B, s, H, D) and lse.shape == (B * H, s)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=0)
    # the TPU kept lse replicated over 128 lanes; the port keeps one column
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, 0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_mha_reference(causal):
    # S=40 is no multiple of 128: the port's kernel masks the ragged edge
    q, k, v = _qkv(40, seed=3)
    scale = 1.0 / np.sqrt(D)
    j = np.swapaxes(np.asarray(_mha_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), causal, scale)), 1, 2)
    out, _ = ca.mha_fwd_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), j, atol=ATOL, rtol=0)


def test_strided_views_and_routing():
    """q/k/v as head-major views of one fused projection (the GPT layout)
    give the same result as contiguous copies; prefill_flash and
    attention_bshd both route to the flash forward."""
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(B, 24, H, 3, D).astype(np.float32))
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    assert not q.is_contiguous()
    scale = 1.0 / np.sqrt(D)
    a, _ = ca.mha_fwd_reference(q, k, v, causal=True, scale=scale)
    b, _ = ca.mha_fwd_reference(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, scale=scale)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(prefill_flash(q, k, v, scale), a, atol=0,
                               rtol=0)
    before = ca.plain_calls
    torch.testing.assert_close(attention_bshd(q, k, v, causal=True,
                                              scale=scale), a, atol=0, rtol=0)
    assert ca.plain_calls == before + 1


def test_wrapper_rejects_non_cpu_non_cuda_device():
    q = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ca.flash_attention_fwd(q, q, q)
