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


# ---------------------------------------- the float32 kernel's arithmetic
# The float32 kernel (csrc/flash_fwd.cu, flash_fwd_tf32_kernel) runs both
# products on tensor cores in 3xTF32: each operand x is split into
# hi = tf32(x) and lo = tf32(x - hi), rounded to nearest even (the
# kernel's cvt.rn.tf32.f32; an inf or NaN stays one), and every 8-wide
# step of a product sums a_lo b_hi, a_hi b_lo, then a_hi b_hi from zero
# (the products of two TF32 values are exact in float32) and joins its
# accumulator in one float add. The softmax is the online one over key
# tiles of 32 keys, with s scale, its max and lse in natural units and
# p = 2^(s log2 e - m log2 e); the running max ignores a NaN score, as
# fmaxf does. The emulation below repeats that maths in
# torch on the CPU (nothing on the main path uses it; the tensor cores'
# truncating sum inside a step is not modelled) and is held at the kernels
# phase's float32 limits: atol/rtol 2e-5 on out, 1e-3 on lse. A single
# TF32 product (hi hi only) keeps ~11 bits and must fail the same limit, or
# the limit could not tell float32 from TF32.
LOG2E = 1.4426950408889634
F32_TOL, LSE_TOL = 2e-5, 1e-3


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest even, on the int32
    view: add just under half of the 13 dropped bits' range plus the kept
    last bit, clear them; an inf or NaN stays as it is."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(
        torch.float32)
    return torch.where(x.isfinite(), rounded, x)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(a, b, three=True):
    """a @ b in 8-wide steps, each step's products as the kernel issues them
    (a_lo b_hi, a_hi b_lo, then a_hi b_hi; ``three=False``: a_hi b_hi alone)
    summed from zero, the steps accumulated in float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        step = ah[..., ks] @ bh[..., ks, :]
        if three:
            step = (al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]
                    + step)
        acc = acc + step
    return acc


def _kernel_emulation(q, k, v, causal, scale, three=True):
    """The float32 kernel's maths on [B, S, H, D] float32 tensors: returns
    (out [B, Sq, H, D], lse [B*H, Sq]). Every row runs every key tile; a
    tile the kernel skips (above a causal block's diagonal) is all masked
    for its rows, so it leaves m, l and o exactly as they were."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    keys = 32
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros(b, h, sq)
    o = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, keys):
        k1 = min(k0 + keys, sk)
        s = _mma(qt, kt[:, :, k0:k1].transpose(-1, -2), three) * scale
        if causal:
            s = s.masked_fill(torch.arange(k0, k1) > rows, -1e30)
        m_new = torch.fmax(m, s.masked_fill(s.isnan(), -1e30).amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mma(p, vt[:, :, k0:k1], three)
        m = m_new
    lc = l.clamp(min=1e-30)
    out = (o / lc[..., None]).transpose(1, 2)
    lse = m + torch.log(lc)
    return out, lse.reshape(b * h, sq)


def _tf32_rounds_to_nearest_even():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -11 + 2.0 ** -23,
                      one + 2.0 ** -11 - 2.0 ** -23, one + 3 * 2.0 ** -11,
                      0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, one + 2.0 ** -10, one,
                         one + 4 * 2.0 ** -11, 0.0, -0.0])
    assert torch.equal(_tf32(x), want)
    # a NaN stays NaN (the card's 0x7fffffff, its negative, the CPU's quiet
    # NaN; added to, 0x7fffffff would carry into the sign bit and round to
    # -0), an inf stays inf
    special = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800000,
                            -0x800000], dtype=torch.int32).view(torch.float32)
    hi, lo = _split(special)
    assert torch.equal(hi.isnan(), special.isnan())
    assert torch.equal(hi.isinf(), special.isinf())
    assert bool(lo.isnan().all())
    # hi + lo keeps ~22 bits: within 2^-22 of x, relative
    rng = np.random.RandomState(7)
    y = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    hi, lo = _split(y)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    rel = ((hi.double() + lo.double() - y.double()).abs()
           / y.double().abs()).max()
    assert rel <= 2.0 ** -22
    assert ((hi.double() - y.double()).abs() / y.double().abs()).max() \
        > 2.0 ** -13


def _tf32_kernel_arithmetic_matches_pallas_interpret(d, causal):
    s = 256
    q, k, v = _qkv_d(s, d, seed=61 + d + causal)
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = _mha_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                            128, 128)
    out, lse = _kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal, scale)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(j_out), 1, 2),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, 0],
                               atol=LSE_TOL, rtol=0)


def _tf32_kernel_arithmetic_matches_references_ragged(s, d, causal):
    """Ragged S (a partial last key tile, and at S=300 several tiles and
    query blocks): against ``_mha_reference`` and the port's plain
    version."""
    q, k, v = _qkv_d(s, d, seed=67 + s + d + causal)
    scale = 1.0 / np.sqrt(d)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = _kernel_emulation(qt, kt, vt, causal, scale)
    j = np.swapaxes(np.asarray(_mha_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), causal, scale)), 1, 2)
    np.testing.assert_allclose(out.numpy(), j, atol=F32_TOL, rtol=F32_TOL)
    p_out, p_lse = ca.mha_fwd_reference(qt, kt, vt, causal=causal,
                                        scale=scale)
    torch.testing.assert_close(out, p_out, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(lse, p_lse, atol=LSE_TOL, rtol=0)


def _single_tf32_product_fails_the_float32_limit():
    """The control: at D=64 S=512 three products pass the float32 limit
    and one (hi hi) does not."""
    s, d = 512, 64
    q, k, v = _qkv_d(s, d, seed=71)
    scale = 1.0 / np.sqrt(d)
    want = np.swapaxes(np.asarray(_mha_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), False, scale)), 1, 2)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    three, _ = _kernel_emulation(qt, kt, vt, False, scale)
    one, _ = _kernel_emulation(qt, kt, vt, False, scale, three=False)
    np.testing.assert_allclose(three.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)
    assert not np.allclose(one.numpy(), want, atol=F32_TOL, rtol=F32_TOL), \
        "one TF32 product passes the float32 limit at D=64 S=512"


def _tf32_kernel_arithmetic_propagates_nan(d, nan_bits):
    """A NaN in one key element (the card's 0x7fffffff, its negative, the
    CPU's quiet NaN): the emulation's out and lse are NaN in exactly the
    entries where the plain version's are (the causal rows at or after that
    key, in its batch and head) and agree with it elsewhere at the float32
    limits."""
    s = 100
    q, k, v = (torch.from_numpy(x) for x in _qkv_d(s, d, seed=73 + d))
    k = k.clone()
    k.view(torch.int32)[0, 40, 1, 3] = nan_bits
    scale = 1.0 / np.sqrt(d)
    out, lse = _kernel_emulation(q, k, v, True, scale)
    p_out, p_lse = ca.mha_fwd_reference(q, k, v, causal=True, scale=scale)
    nan = p_out.isnan()
    assert int(p_lse.isnan().sum()) == s - 40
    assert torch.equal(out.isnan(), nan)
    assert torch.equal(lse.isnan(), p_lse.isnan())
    torch.testing.assert_close(out[~nan], p_out[~nan], atol=F32_TOL,
                               rtol=F32_TOL)
    fin = ~p_lse.isnan()
    torch.testing.assert_close(lse[fin], p_lse[fin], atol=LSE_TOL, rtol=0)
