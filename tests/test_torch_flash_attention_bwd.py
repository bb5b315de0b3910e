"""Port parity: the flash-attention backward's plain version
(paddle_tpu_torch/ops/cuda_attention_bwd.py::mha_bwd_reference, which CPU
tensors take through the kernels' wrapper) against the JAX package's Pallas
backward ``pallas_attention._mha_bwd`` in interpret mode and against
``jax.vjp`` of ``_mha_reference``; and the autograd ``FlashAttention``
through ``attention_bshd`` against ``jax.vjp(mha)``. float32 from seeded
numpy, atol 1e-5 (float32 sums in another order). The kernels themselves run
only on the card (chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_attention import (LANES, _mha_bwd, _mha_fwd,
                                             _mha_reference, mha)
from paddle_tpu_torch.ops import cuda_attention_bwd as cab
from paddle_tpu_torch.ops.flash_attention import attention_bshd

B, H, D = 2, 2, 64
ATOL = 1e-5


def _inputs(s, seed, b=B):
    """q, k, v, dO as [b, S, H, D] float32."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, H, D).astype(np.float32) for _ in range(4)]


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


def _bshd(x):
    return np.swapaxes(np.asarray(x), 1, 2)


@pytest.mark.parametrize("s,causal,with_ct", [
    (128, True, False), (128, False, False), (256, True, False),
    (256, False, False), (128, True, True)])
def test_reference_matches_pallas_bwd_interpret(s, causal, with_ct):
    # the reference folds lse_ct in as di[b, h, s] - lse_ct.reshape(b*h, s),
    # which broadcasts only at batch 1 (ROADMAP queue 3)
    b = 1 if with_ct else B
    q, k, v, do = _inputs(s, seed=s + 2 * causal + with_ct, b=b)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (_bhsd(x) for x in (q, k, v, do))
    j_out, j_lse = _mha_fwd(jq, jk, jv, causal, scale, 128, 128)
    ct = (np.random.RandomState(9).randn(b * H, s).astype(np.float32)
          if with_ct else None)
    jdq, jdk, jdv = _mha_bwd(jq, jk, jv, j_out, j_lse, jdo, causal, scale,
                             128, 128,
                             lse_ct=None if ct is None else jnp.asarray(
                                 ct.reshape(b, H, s)))
    # the port keeps lse as [B*H, S]: the TPU's 128 lanes hold one value
    lse = np.asarray(j_lse)
    assert lse.shape[-1] == LANES and np.all(lse == lse[:, :, :1])
    before = dict(cab.plain_calls)
    got = cab.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_bshd(j_out).copy()),
        torch.from_numpy(lse[:, :, 0].copy()),
        torch.from_numpy(do), causal=causal, scale=scale,
        lse_ct=None if ct is None else torch.from_numpy(ct))
    assert all(cab.plain_calls[n] == before[n] + 1 for n in cab.KERNELS)
    for name, a, want in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        assert a.shape == (b, s, H, D) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), _bshd(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_vjp_of_mha_reference(causal):
    # S=40 is no multiple of 128: the port's kernels mask the ragged edge
    q, k, v, do = _inputs(40, seed=7 + causal)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = (_bhsd(x) for x in (q, k, v))
    out, vjp = jax.vjp(lambda a, b_, c: _mha_reference(a, b_, c, causal,
                                                       scale), jq, jk, jv)
    want = vjp(_bhsd(do))
    # the lse the forward would save, from the same float scores
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        logits = np.where(np.tril(np.ones((40, 40), bool)), logits, -1e30)
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    got = cab.mha_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_bshd(out).copy()),
        torch.from_numpy(lse.reshape(B * H, 40).astype(np.float32)),
        torch.from_numpy(do), causal=causal, scale=scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), _bshd(w), atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("s,causal", [(128, True), (40, True), (96, False)])
def test_autograd_function_matches_vjp_of_mha(s, causal):
    """attention_bshd's gradient (the FlashAttention Function: forward
    wrapper, then one call of the backward wrapper) equals jax.vjp of the
    reference's custom-vjp ``mha`` (its Pallas forward in interpret mode where
    S is a multiple of 128, ``_mha_reference`` otherwise)."""
    q, k, v, do = _inputs(s, seed=11 + s)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = (_bhsd(x) for x in (q, k, v))
    if s % 128 == 0:
        fn = lambda a, b_, c: mha(a, b_, c, causal, scale, 128, 128)  # noqa
    else:
        fn = lambda a, b_, c: _mha_reference(a, b_, c, causal,  # noqa: E731
                                             scale)
    j_out, vjp = jax.vjp(fn, jq, jk, jv)
    want = vjp(_bhsd(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(cab.plain_calls)
    out = attention_bshd(tq, tk, tv, causal=causal, scale=scale)
    np.testing.assert_allclose(out.detach().numpy(), _bshd(j_out),
                               atol=ATOL, rtol=0)
    assert cab.plain_calls == before           # nothing before backward
    out.backward(torch.from_numpy(do))
    assert all(cab.plain_calls[n] == before[n] + 1 for n in cab.KERNELS)
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), _bshd(w), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_no_grad_saves_nothing_and_skips_the_function():
    """Serving runs under no_grad: attention_bshd calls the forward alone
    and its output carries no graph."""
    q, k, v, _ = _inputs(24, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = attention_bshd(tq, tk, tv, causal=True)
    assert out.grad_fn is None and not out.requires_grad
    out = attention_bshd(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


def test_bf16_rounds_p_and_ds_as_the_reference():
    """In bf16 the plain version rounds p before dv and ds before dq/dk, as
    the TPU kernels round them to the input type: equal to the float32
    maths with those two roundings written out."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(48, seed=5))
    scale = 1.0 / np.sqrt(D)
    from paddle_tpu_torch.ops.cuda_attention import mha_fwd_reference
    out, lse = mha_fwd_reference(q, k, v, causal=True, scale=scale)
    dq, dk, dv = cab.mha_bwd_reference(q, k, v, out, lse, do, causal=True,
                                       scale=scale)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(48, 48, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - lse.reshape(B, H, 48, 1))
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dof @ vf.transpose(-1, -2) - delta) * scale).bfloat16()
    want_dv = p.bfloat16().float().transpose(-1, -2) @ dof
    want_dq = ds.float() @ kf
    want_dk = ds.float().transpose(-1, -2) @ qf
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want.transpose(1, 2).bfloat16(),
                                   atol=0, rtol=0)
