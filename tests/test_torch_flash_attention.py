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


# ------------------------------------------------- the bf16 kernel's tile edges
# The bf16 kernel works in blocks of 128 query rows and tiles of 128 keys; its
# plain version is held to the JAX reference just below, at and across those
# edges, for both head dims (the kernel itself: chip_smoke.py's kernels phase).

def _qkv_d(s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, H, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [63, 127, 129, 255])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_edges_match_mha_reference(s, d, causal):
    q, k, v = _qkv_d(s, d, seed=s * 7 + d + causal)
    scale = 1.0 / np.sqrt(d)
    j = np.swapaxes(np.asarray(_mha_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), causal, scale)), 1, 2)
    out, lse = ca.flash_attention_fwd(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal=causal,
                                      scale=scale)
    np.testing.assert_allclose(out.numpy(), j, atol=ATOL, rtol=0)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) * scale
    if causal:
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(B * H, s),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_128_matches_pallas_interpret(causal):
    # D=64 at S=256: test_out_and_lse_match_pallas_interpret
    s, d = 256, 128
    q, k, v = _qkv_d(s, d, seed=d + causal)
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = _mha_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                            128, 128)
    out, lse = ca.flash_attention_fwd(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal=causal,
                                      scale=scale)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(j_out), 1, 2),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, 0],
                               atol=ATOL, rtol=0)


# -------------------------------------- layouts the TMA path takes or refuses
# _check runs before every launch; on CPU tensors it is called directly. The
# bf16 kernel's tensor maps need a 16-byte aligned base and b/s/h strides of
# whole 16 bytes (8 bf16).

def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_takes_fused_views_and_contiguous(d, dtype):
    qkv = torch.zeros(2, 40, 4, 3, d, dtype=dtype)
    q, k, v = qkv.unbind(3)
    assert not q.is_contiguous()
    ca._check(q, k, v, causal=True)
    ca._check(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    # k and v of another length than q, full attention
    kv = torch.zeros(2, 70, 4, 2, d, dtype=dtype)
    ca._check(q, kv[:, :, :, 0], kv[:, :, :, 1], causal=False)


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_check_refuses_strides_not_multiple_of_8(dim, which):
    b, s, h, d = 2, 16, 4, 64
    strides = [s * h * d * 2, h * d * 2, d * 2, 1]
    strides[dim] += 4                       # 8 bytes: no whole 16
    bad = torch.as_strided(_bf16(4 * b * s * h * d), (b, s, h, d), strides)
    t = {n: _bf16(b, s, h, d) for n in "qkv"}
    t[which] = bad
    with pytest.raises(ValueError, match="16-byte"):
        ca._check(t["q"], t["k"], t["v"], causal=True)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_check_refuses_unaligned_base_pointer(which):
    shape = (2, 16, 4, 64)
    n = int(np.prod(shape))
    shifted = _bf16(n + 8)[1:1 + n].view(shape)
    assert shifted.data_ptr() % 16
    t = {name: _bf16(*shape) for name in "qkv"}
    t[which] = shifted
    with pytest.raises(ValueError, match="16-byte"):
        ca._check(t["q"], t["k"], t["v"], causal=False)


@pytest.mark.parametrize("d", [32, 96, 256])
def test_check_refuses_head_dims(d):
    q = _bf16(1, 8, 2, d)
    with pytest.raises(ValueError, match="head_dim"):
        ca._check(q, q, q, causal=True)


def test_check_refuses_causal_with_sq_ne_sk():
    q, kv = _bf16(1, 8, 2, 64), _bf16(1, 16, 2, 64)
    with pytest.raises(ValueError, match="sq=8 != sk=16"):
        ca._check(q, kv, kv, causal=True)
    ca._check(q, kv, kv, causal=False)


# ------------------------------------------------------------- float16
# fp16 AMP training takes the same kernel in float16 (one template over the
# element type). Its plain version computes in float from float16 inputs and
# rounds the output, as ``_mha_reference`` does; the Pallas kernel also
# rounds its probabilities to v's type. F16_ATOL = 2e-3: outputs of size
# up to ~2 round to float16 within half an ulp (2^-10 at 1-2), and the
# Pallas kernel's float16 probabilities move them by about as much.
F16_ATOL = 2e-3


def _qkv_f16(s, d, seed):
    return [x.astype(np.float16) for x in _qkv_d(s, d, seed)]


@pytest.mark.parametrize("s", [63, 129])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_float16_matches_mha_reference(s, d, causal):
    q, k, v = _qkv_f16(s, d, seed=s * 3 + d + causal)
    scale = 1.0 / np.sqrt(d)
    j = np.swapaxes(np.asarray(_mha_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), causal, scale)), 1, 2)
    assert j.dtype == np.float16
    before = ca.plain_calls
    out, lse = ca.flash_attention_fwd(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal=causal,
                                      scale=scale)
    assert ca.plain_calls == before + 1
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), j.astype(np.float32),
                               atol=F16_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_float16_matches_pallas_interpret(causal):
    s, d = 256, 128
    q, k, v = _qkv_f16(s, d, seed=41 + causal)
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = _mha_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                            128, 128)
    out, lse = ca.flash_attention_fwd(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal=causal,
                                      scale=scale)
    np.testing.assert_allclose(
        out.float().numpy(),
        np.swapaxes(np.asarray(j_out), 1, 2).astype(np.float32),
        atol=F16_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, 0],
                               atol=ATOL, rtol=0)


def test_float16_takes_the_flash_route():
    """attention_bshd sends float16 at D=64/128 to the kernel's wrapper
    (which runs the plain version on CPU tensors), not to a refused
    shape's route."""
    q, k, v = (torch.from_numpy(x) for x in _qkv_f16(40, 64, seed=43))
    assert ca.supported(q, k, v, causal=True, backward=True)
    before = ca.plain_calls
    out = attention_bshd(q, k, v, causal=True)
    assert ca.plain_calls == before + 1 and out.dtype == torch.float16
