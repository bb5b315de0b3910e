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


# ------------------------------------------------ the bf16 kernels' tile edges
# The bf16 kernels own blocks of 128 rows (queries for dq, keys for dk/dv)
# and stream tiles of 64 rows: S one below, at and one above each edge, at
# both head dims, through the wrapper on CPU tensors (the plain version).

def _vjp_case(sq, sk, d, causal, seed):
    """q, k, v, dO ([B, S, H, d] float32), jax.vjp of _mha_reference (its
    out and (dq, dk, dv)) and the forward's lse ([B*H, Sq], from float64
    scores)."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, sq, H, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, sk, H, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    out, vjp = jax.vjp(lambda a, b_, c: _mha_reference(a, b_, c, causal,
                                                       scale),
                       _bhsd(q), _bhsd(k), _bhsd(v))
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) * scale
    if causal:
        logits = np.where(np.tril(np.ones((sq, sk), bool)), logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    return (q, k, v, do, out, vjp(_bhsd(do)),
            lse.reshape(B * H, sq).astype(np.float32), scale)


# test_tile_edges_match_vjp_of_mha_reference runs these cases by head dim
# from files of their own (test_torch_flash_attention_bwd_tiles_d*.py), so
# that the test runner spreads them over its workers
TILE_EDGE_S = [63, 64, 65, 127, 128, 129, 255]


def test_full_attention_with_other_kv_length_matches_vjp():
    # Sq = 129 and Sk = 65: one row past a dq block's and a dk/dv tile's edge
    _tile_edge_case(129, 65, 128, False, seed=31)


def _tile_edge_case(sq, sk, d, causal, seed):
    q, k, v, do, out, want, lse, scale = _vjp_case(sq, sk, d, causal, seed)
    got = cab.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_bshd(out).copy()), torch.from_numpy(lse),
        torch.from_numpy(do), causal=causal, scale=scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == _bshd(w).shape
        np.testing.assert_allclose(a.numpy(), _bshd(w), atol=ATOL, rtol=0,
                                   err_msg=name)


# ------------------------------------------- what the bf16 kernels refuse
# _check_bwd runs before every launch; on CPU tensors it is called directly.

def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _bwd_args(b=2, s=16, h=4, d=64):
    q, k, v, out, do = (_bf16(b, s, h, d) for _ in range(5))
    return q, k, v, out, torch.zeros(b * h, s), do


def test_check_bwd_takes_fused_views():
    q, k, v = _bf16(2, 40, 4, 3, 64).unbind(3)
    _, _, _, out, lse, do = _bwd_args(s=40)
    cab._check_bwd(q, k, v, out, lse, do, causal=True)


@pytest.mark.parametrize("what", ["base", "b", "s", "h"])
def test_check_bwd_refuses_unaligned_do(what):
    q, k, v, out, lse, do = _bwd_args()
    b, s, h, d = do.shape
    if what == "base":
        n = b * s * h * d
        do = _bf16(n + 8)[1:1 + n].view(do.shape)
        assert do.data_ptr() % 16
    else:
        strides = [s * h * d * 2, h * d * 2, d * 2, 1]
        strides["bsh".index(what)] += 4      # 8 bytes: no whole 16
        do = torch.as_strided(_bf16(4 * b * s * h * d), do.shape, strides)
    with pytest.raises(ValueError, match="dO: .*16-byte"):
        cab._check_bwd(q, k, v, out, lse, do, causal=True)


def test_check_bwd_refuses_unaligned_lse():
    q, k, v, out, lse, do = _bwd_args()
    lse = torch.zeros(lse.numel() + 1)[1:].view(lse.shape)
    assert lse.data_ptr() % 16
    with pytest.raises(ValueError, match="lse: .*16-byte"):
        cab._check_bwd(q, k, v, out, lse, do, causal=True)


@pytest.mark.parametrize("side", ["dq", "dkv"])
def test_check_bwd_refuses_grids_over_2_31_blocks(side):
    # 2^31 blocks of 128 rows, as stride-0 views that hold no memory:
    # dq's grid runs over the queries, dk/dv's over the keys
    big, small = 128 * 2**31, 8
    sq, sk = (big, small) if side == "dq" else (small, big)
    one = _bf16(1, 1, 1, 64)
    q, out, do = (one.expand(1, sq, 1, 64) for _ in range(3))
    k, v = (one.expand(1, sk, 1, 64) for _ in range(2))
    lse = torch.zeros(1, small)
    with pytest.raises(ValueError, match=r"2\^31 - 1 blocks"):
        cab._check_bwd(q, k, v, out, lse, do, causal=False)


# ------------------------------------------------------------- float16
# The plain version rounds p and ds to float16 as the Pallas kernels round
# them to the input type (pallas_attention.py:204, 252, 258); gradients of
# size up to ~6 round to float16 within half an ulp (2^-9 at 4-8), and the
# two round p and ds after float sums in another order. F16_ATOL = 4e-3
# (about one float16 ulp at 4).
F16_ATOL = 4e-3


@pytest.mark.parametrize("s,causal", [(128, True), (256, False)])
def test_float16_matches_pallas_bwd_interpret(s, causal):
    q, k, v, do = (x.astype(np.float16) for x in _inputs(s, seed=50 + s))
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (_bhsd(x) for x in (q, k, v, do))
    j_out, j_lse = _mha_fwd(jq, jk, jv, causal, scale, 128, 128)
    jdq, jdk, jdv = _mha_bwd(jq, jk, jv, j_out, j_lse, jdo, causal, scale,
                             128, 128)
    got = cab.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_bshd(j_out).copy()),
        torch.from_numpy(np.asarray(j_lse)[:, :, 0].copy()),
        torch.from_numpy(do), causal=causal, scale=scale)
    for name, a, want in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(a.float().numpy(),
                                   _bshd(want).astype(np.float32),
                                   atol=F16_ATOL, rtol=F16_ATOL,
                                   err_msg=name)


def test_float16_overflow_reaches_every_gradient():
    """A float16 cotangent that overflowed (a loss scaled past float16's
    range leaves inf in dO) gives non-finite dq, dk and dv, in the plain
    version as in the reference's Pallas backward: nothing clamps it, so
    dynamic loss scaling sees the overflow (the kernels: chip_smoke.py's
    overflow case)."""
    s = 128
    q, k, v, do = (x.astype(np.float16) for x in _inputs(s, seed=60))
    with np.errstate(over="ignore"):     # the overflow is the point
        do = (do.astype(np.float32) * 3e4).astype(np.float16)
    assert not np.isfinite(do).all()
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (_bhsd(x) for x in (q, k, v, do))
    j_out, j_lse = _mha_fwd(jq, jk, jv, True, scale, 128, 128)
    jgrads = _mha_bwd(jq, jk, jv, j_out, j_lse, jdo, True, scale, 128, 128)
    got = cab.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_bshd(j_out).copy()),
        torch.from_numpy(np.asarray(j_lse)[:, :, 0].copy()),
        torch.from_numpy(do), causal=True, scale=scale)
    for name, a, j in zip(("dq", "dk", "dv"), got, jgrads):
        assert not torch.isfinite(a).all(), name
        assert not np.isfinite(np.asarray(j)).all(), name


# ---------------------------------------- the float32 kernels' arithmetic
# The float32 kernels (csrc/flash_bwd.cu, dq_tf32_kernel and
# dkv_tf32_kernel) run every product on tensor cores in 3xTF32, as the
# forward does (the TF32 helpers are the forward tests'): each operand split
# into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest even, every
# 8-wide step of a product summing a_lo b_hi, a_hi b_lo, then a_hi b_hi from
# zero. dq streams K/V tiles of DQ_TILE keys past its query rows: per tile
# S = Q K^T and dP = dO V^T (8-dim steps joined into the scores one float add
# at a time), p = 2^(s scale log2 e - lse log2 e) (one rounding, the
# kernels' FFMA; 0 where masked), ds = p (dp - delta) scale, and the tile's
# dS K summed from zero joins dQ in one float add. dk/dv is its transpose
# over Q/dO tiles of DKV_TILE queries: S^T, dP^T, then P^T dO and dS^T Q,
# each tile's sum joined to dV and dK in one add. The emulation repeats that
# maths in torch on the CPU (the tensor cores' truncating sum inside a step
# is not modelled; every tile runs, since a tile the kernels skip is all
# masked and adds exact zeros) and is held at the kernels phase's float32
# limit, max abs err <= 2e-5 x (1 + max |reference|), against the reference's
# Pallas backward in interpret mode and the port's plain version. A single
# TF32 product (hi hi only) must fail the same limit.
from test_torch_flash_attention import LOG2E, _mma  # noqa: E402

# the float32 kernels' tiles (csrc/flash_bwd.cu, F32Bwd): keys of dq's
# streamed tile and queries of dk/dv's, by head dim
DQ_TILE = {64: 32, 128: 32}
DKV_TILE = {64: 64, 128: 32}
F32_TOL = 2e-5


def _p_ds(s, dp, lse, delta, scale, mask):
    """p and ds of a tile as the kernels build them from raw scores ``s``
    and ``dp`` (lse and delta broadcast against them)."""
    x = s * scale
    l2 = lse * LOG2E
    p = torch.exp2((x.double() * LOG2E - l2.double()).float())
    p = torch.where(mask, p, torch.zeros(()))
    return p, p * (dp - delta) * scale


def _bwd_emulation(q, k, v, do, lse, delta, causal, scale, three=True):
    """The two float32 kernels' maths on [B, S, H, D] float32 tensors (lse
    and delta [B*H, Sq], delta already less any lse cotangent): returns
    (dq, dk, dv) as [B, S, H, D]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    lse, delta = (x.reshape(b, h, sq) for x in (lse, delta))
    qpos, kpos = torch.arange(sq), torch.arange(sk)
    dq = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, DQ_TILE[d]):
        k1 = min(k0 + DQ_TILE[d], sk)
        ks, vs = kt[:, :, k0:k1], vt[:, :, k0:k1]
        s = _mma(qt, ks.transpose(-1, -2), three)
        dp = _mma(dot, vs.transpose(-1, -2), three)
        mask = (kpos[k0:k1][None, :] <= qpos[:, None] if causal
                else torch.ones(sq, k1 - k0, dtype=torch.bool))
        _, ds = _p_ds(s, dp, lse[..., None], delta[..., None], scale, mask)
        dq = dq + _mma(ds, ks, three)
    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
    for q0 in range(0, sq, DKV_TILE[d]):
        q1 = min(q0 + DKV_TILE[d], sq)
        qs, dos = qt[:, :, q0:q1], dot[:, :, q0:q1]
        st = _mma(kt, qs.transpose(-1, -2), three)
        dpt = _mma(vt, dos.transpose(-1, -2), three)
        mask = (kpos[:, None] <= qpos[q0:q1][None, :] if causal
                else torch.ones(sk, q1 - q0, dtype=torch.bool))
        p, ds = _p_ds(st, dpt, lse[:, :, None, q0:q1],
                      delta[:, :, None, q0:q1], scale, mask)
        dv = dv + _mma(p, dos, three)
        dk = dk + _mma(ds, qs, three)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _kernel_bwd(tq, tk, tv, tdo, out, lse, causal, scale, ct=None,
                three=True, centered=True):
    """The emulated kernels on what the wrapper hands them in float32: K
    and V less their mean key and value (``cab._centered``), then dQ's
    lse-cotangent term added back; ``centered=False``: the raw operands and
    the plain delta, as before that repair."""
    if not centered:
        return _bwd_emulation(tq, tk, tv, tdo, lse, cab._delta(out, tdo, ct),
                              causal, scale, three)
    kc, vc, lc, delta, ck = cab._centered(tq, tk, tv, out, lse, tdo, ct,
                                          scale)
    dq, dk, dv = _bwd_emulation(tq, kc, vc, tdo, lc, delta, causal, scale,
                                three)
    dq = dq.contiguous()
    if ct is not None:
        cab._lse_ct_term(dq, ct, ck, scale)
    return dq, dk, dv


def _emulate(q, k, v, do, causal, scale, lse_ct=None, three=True):
    """The forward's plain out and lse (what the kernels read), and the
    emulated (dq, dk, dv) on the wrapper's operands; numpy in, torch
    out."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    from paddle_tpu_torch.ops.cuda_attention import mha_fwd_reference
    out, lse = mha_fwd_reference(tq, tk, tv, causal=causal, scale=scale)
    ct = None if lse_ct is None else torch.from_numpy(lse_ct)
    grads = _kernel_bwd(tq, tk, tv, tdo, out, lse, causal, scale, ct, three)
    return (tq, tk, tv, tdo, out, lse, ct), grads


def _within_limit(got, want, name):
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    lim = F32_TOL * (1.0 + np.abs(want).max())
    assert err <= lim, f"{name}: max abs err {err:.3e} beyond {lim:.3e}"


def _inputs_d(sq, d, seed, sk=None, b=B):
    """q, dO [b, Sq, H, d] and k, v [b, Sk, H, d] float32."""
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    q, k, v, do = (rng.randn(b, n, H, d).astype(np.float32)
                   for n in (sq, sk, sk, sq))
    return q, k, v, do


def _tf32_bwd_arithmetic_matches_pallas_interpret(d, causal):
    """jax.vjp of the reference's ``mha`` (its Pallas forward and backward
    in interpret mode) against the emulation and the plain version."""
    s = 256
    q, k, v, do = _inputs_d(s, d, seed=81 + d + causal)
    scale = 1.0 / np.sqrt(d)
    _, vjp = jax.vjp(lambda a, b_, c: mha(a, b_, c, causal, scale, 128,
                                          128), *(_bhsd(x) for x in (q, k, v)))
    want = vjp(_bhsd(do))
    (tq, tk, tv, tdo, out, lse, _), got = _emulate(q, k, v, do, causal,
                                                   scale)
    plain = cab.mha_bwd_reference(tq, tk, tv, out, lse, tdo, causal=causal,
                                  scale=scale)
    for name, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        _within_limit(a.numpy(), _bshd(w), name)
        _within_limit(a.numpy(), pl.numpy(), name + " (plain)")


def _tf32_bwd_arithmetic_with_lse_cotangent():
    """delta less an lse cotangent (batch 1, where the reference's fold-in
    broadcasts): the reference's ``_mha_bwd`` in interpret mode."""
    s, d = 128, 64
    q, k, v, do = _inputs_d(s, d, seed=87, b=1)
    ct = np.random.RandomState(88).randn(H, s).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (_bhsd(x) for x in (q, k, v, do))
    j_out, j_lse = _mha_fwd(jq, jk, jv, True, scale, 128, 128)
    want = _mha_bwd(jq, jk, jv, j_out, j_lse, jdo, True, scale, 128, 128,
                    lse_ct=jnp.asarray(ct.reshape(1, H, s)))
    (tq, tk, tv, tdo, out, lse, tct), got = _emulate(q, k, v, do, True,
                                                     scale, lse_ct=ct)
    plain = cab.mha_bwd_reference(tq, tk, tv, out, lse, tdo, causal=True,
                                  scale=scale, lse_ct=tct)
    for name, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        _within_limit(a.numpy(), _bshd(w), name)
        _within_limit(a.numpy(), pl.numpy(), name + " (plain)")


def _tf32_bwd_arithmetic_matches_references_ragged(sq, sk, causal, d):
    """Ragged S (partial last tiles on both kernels' sides, several tiles
    and blocks) and full attention over a K/V length other than Q's:
    against jax.vjp of ``_mha_reference`` and the port's plain version."""
    q, k, v, do = _inputs_d(sq, d, seed=89 + sq + sk + d + causal, sk=sk)
    scale = 1.0 / np.sqrt(d)
    _, vjp = jax.vjp(lambda a, b_, c: _mha_reference(a, b_, c, causal,
                                                     scale),
                     *(_bhsd(x) for x in (q, k, v)))
    want = vjp(_bhsd(do))
    (tq, tk, tv, tdo, out, lse, _), got = _emulate(q, k, v, do, causal,
                                                   scale)
    plain = cab.mha_bwd_reference(tq, tk, tv, out, lse, tdo, causal=causal,
                                  scale=scale)
    for name, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert a.shape == pl.shape
        _within_limit(a.numpy(), _bshd(w), name)
        _within_limit(a.numpy(), pl.numpy(), name + " (plain)")


def _single_tf32_product_fails_the_float32_backward_limit():
    """The control: at D=64 S=512 three products pass the float32 limit
    and one (hi hi) does not."""
    s, d = 512, 64
    q, k, v, do = _inputs_d(s, d, seed=97)
    scale = 1.0 / np.sqrt(d)
    _, vjp = jax.vjp(lambda a, b_, c: _mha_reference(a, b_, c, False,
                                                     scale),
                     *(_bhsd(x) for x in (q, k, v)))
    want = [_bshd(w) for w in vjp(_bhsd(do))]
    _, three = _emulate(q, k, v, do, False, scale)
    _, one = _emulate(q, k, v, do, False, scale, three=False)
    for name, a, w in zip(("dq", "dk", "dv"), three, want):
        _within_limit(a.numpy(), w, name)
    failed = []
    for name, a, w in zip(("dq", "dk", "dv"), one, want):
        try:
            _within_limit(a.numpy(), w, name)
        except AssertionError:
            failed.append(name)
    assert failed, "one TF32 product passes the float32 limit at D=64 S=512"


def _cancelling_inputs(seed, b=1, s=384, h=1, d=64):
    """q, k, v, dO [b, S, H, D] float32 where dQ cancels: small queries, so
    attention over the S keys is near-uniform, and keys and values that
    share a large part (a per-head vector of norm ~24 beside per-token
    parts of norm ~4), as deep layers of a model make them."""
    rng = np.random.RandomState(seed)
    q = 0.05 * rng.randn(b, s, h, d)
    k = 3.0 * rng.randn(1, 1, h, d) + 0.5 * rng.randn(b, s, h, d)
    v = 3.0 * rng.randn(1, 1, h, d) + 0.5 * rng.randn(b, s, h, d)
    do = rng.randn(b, s, h, d)
    return [x.astype(np.float32) for x in (q, k, v, do)]


def _rel_to_largest(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()
                 / np.abs(want).max())


def _tf32_bwd_cancelling_dq_keeps_float32_accuracy():
    """The float32 pipeline as the card runs it (the forward kernel's
    emulated out and lse, the wrapper's operands, the backward kernels'
    emulated maths) on a dQ that cancels: each gradient within 2e-5 of its
    largest from float64. The control: the same kernels on the raw K, V
    and δ (before the repair) leave dQ 1e-4 or more of its largest off."""
    import test_torch_flash_attention as fa
    q, k, v, do = _cancelling_inputs(seed=101)
    scale = 1.0 / np.sqrt(q.shape[-1])
    t64 = [torch.from_numpy(x).double().requires_grad_() for x in
           (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in t64)
    p = torch.softmax(qt @ kt.transpose(-1, -2) * scale, -1)
    want = torch.autograd.grad((p @ vt).transpose(1, 2), t64,
                               torch.from_numpy(do).double())
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa._kernel_emulation(tq, tk, tv, False, scale)
    got = _kernel_bwd(tq, tk, tv, tdo, out, lse, False, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = _rel_to_largest(a.numpy(), w.numpy())
        assert err <= F32_TOL, f"{name}: {err:.3e} of its largest"
    raw = _kernel_bwd(tq, tk, tv, tdo, out, lse, False, scale,
                      centered=False)
    assert _rel_to_largest(raw[0].numpy(), want[0].numpy()) >= 1e-4


def _tf32_bwd_arithmetic_propagates_nan_in_do(d, nan_bits):
    """A NaN in one element of dO (the card's 0x7fffffff, the CPU's quiet
    NaN), full attention: the emulation's dq, dk and dv are NaN in exactly
    the entries where the plain version's are (that query's dq row, every
    dk row of its batch and head, that dim of every dv row there) and agree
    with it elsewhere at the float32 limit. (Under a causal mask the plain
    version multiplies the masked p, 0, by the NaN too, where the kernels
    skip the tiles their mask empties.)"""
    s = 100
    q, k, v, do = _inputs_d(s, d, seed=99 + d)
    do = do.copy()
    do.view(np.int32)[0, 40, 1, 3] = nan_bits
    scale = 1.0 / np.sqrt(d)
    (tq, tk, tv, tdo, out, lse, _), got = _emulate(q, k, v, do, False,
                                                   scale)
    plain = cab.mha_bwd_reference(tq, tk, tv, out, lse, tdo, causal=False,
                                  scale=scale)
    expect = {"dq": d, "dk": s * d, "dv": s}
    for name, a, pl in zip(("dq", "dk", "dv"), got, plain):
        nan = pl.isnan()
        assert int(nan.sum()) == expect[name], name
        assert torch.equal(a.isnan(), nan), name
        _within_limit(a[~nan].numpy(), pl[~nan].numpy(), name)


# ------------------------------ float32 rows off 16-byte alignment
# The float32 kernels load rows with 16-byte cp.async copies, and
# pt_flash_bwd_dq / pt_flash_bwd_dkv refuse a float32 view whose rows are
# not 16-byte aligned (cudaErrorInvalidValue). The wrapper's launch copies
# such a view first; a stand-in for the library checks what reaches the C
# entry points.

class _EntryPoints:
    """The two C entry points' alignment rule over their arguments (q, k,
    v, dO first; the b/s/h strides of q, k, v and dO as an int64[12] five
    places after the outputs), with what each call received."""

    def __init__(self):
        self.calls = []

    def _entry(self, name, args, n_ptrs):
        strides = list(args[n_ptrs + 5])
        ok = (all(p % 16 == 0 for p in args[:4])
              and all(st % 4 == 0 for st in strides))
        self.calls.append((name, ok))
        return 0 if ok else 1          # cudaErrorInvalidValue

    def pt_flash_bwd_dq(self, *args):
        return self._entry("dq", args, 7)

    def pt_flash_bwd_dkv(self, *args):
        return self._entry("dkv", args, 8)


def _launch_inputs(q, k, v, do):
    b, s, h, d = q.shape
    lse, delta = torch.zeros(b * h, s), torch.zeros(b * h, s)
    outs = [torch.empty(b, s, h, d) for _ in range(3)]
    return (q, k, v, do, lse, delta, *outs, True, 1.0 / np.sqrt(d))


def _unaligned(b=2, s=8, h=2, d=64):
    n = b * s * h * d
    return [torch.zeros(n + 1)[1:].view(b, s, h, d) for _ in range(4)]


def test_unaligned_float32_rows_are_copied_before_the_launch():
    q, k, v, do = _unaligned()
    assert all(t.data_ptr() % 16 for t in (q, k, v, do))
    lib = _EntryPoints()
    before = dict(cab.launches)
    try:
        cab._launch(lib, 0, *_launch_inputs(q, k, v, do))
        assert all(cab.launches[n] == before[n] + 1 for n in cab.KERNELS)
    finally:
        cab.launches.update(before)
    assert lib.calls == [("dq", True), ("dkv", True)]


def test_the_entry_points_refuse_what_the_copy_fixes(monkeypatch):
    """The control: without the copy the same view reaches the entry
    point's refusal, and the wrapper raises."""
    monkeypatch.setattr(cab, "_rows_aligned", lambda t: t)
    lib = _EntryPoints()
    before = dict(cab.launches)
    try:
        with pytest.raises(RuntimeError, match="flash_bwd_dq: CUDA error 1"):
            cab._launch(lib, 0, *_launch_inputs(*_unaligned()))
        assert cab.launches == before
    finally:
        cab.launches.update(before)
    assert lib.calls == [("dq", False)]


def test_aligned_fused_float32_views_are_not_copied():
    q, k, v = torch.zeros(2, 8, 2, 3, 64).unbind(3)
    do = torch.zeros(2, 8, 2, 64)
    for t in (q, k, v, do):
        assert cab._rows_aligned(t) is t
