"""Port parity: what the kernels do not take goes to their plain versions, as
the reference sends it to its dense and gather paths.

The reference routes by ``flash_attention.supported`` (head_dim in {64, 128,
256}, ``paddle_tpu/ops/flash_attention.py:42-55``) and by
``pallas_paged_attention.supported`` (``:69-80``; the caller falls back to
``gather_pool`` and the pure attention, ``paged_attention.py:381-387``). The
port's ``cuda_attention.supported`` and ``cuda_paged_attention.supported``
decide from shape metadata alone (checked here on ``meta`` tensors, which
have shapes, dtypes and strides and no storage), and the callers
(``attention_bshd``, ``prefill_flash``, ``paged_attention_update``) take the
plain version where they are false, counted in its ``plain_calls``. The
kernel-route functions are patched to fail if reached. ``gpt_tiny`` (head_dim
16) then decodes through ``CachedDecoder`` and trains two ``TrainStep``
steps against the JAX package at the existing parity tests' tolerances
(logits atol 1e-4 as ``test_torch_gpt``; losses and parameters rtol 2e-4,
atol 2e-5 as ``test_torch_train``).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving.generation.model_fns import CachedDecoder as JDecoder
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_attention_bwd as cab
from paddle_tpu_torch.ops import cuda_paged_attention as cpa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
from test_torch_gpt import ATOL as LOGIT_ATOL
from test_torch_gpt import _tables, make_pair
from test_torch_train import (_arrays, _assert_matches, _ids, _jax_model,
                              _jax_train, _port_train)

REFUSED_HEAD_DIMS = (16, 32, 80, 96, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the flash kernels also take float16 (fp16 AMP training); the paged kernel
# does not yet (ROADMAP 2b)
FLASH_DTYPES = DTYPES + (torch.float16,)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _qkv_meta(d, dtype, s=64, fused=True):
    """q/k/v as the GPT layer hands them over: views of one fused
    [B, S, H, 3, D] projection (or three contiguous tensors)."""
    if fused:
        return _meta(2, s, 4, 3, d, dtype=dtype).unbind(3)
    return tuple(_meta(2, s, 4, d, dtype=dtype) for _ in range(3))


def _paged_meta(d, dtype, page_size=16, kv="model", b=3, s=1, h=4):
    q = _meta(b, s, h, d, dtype=dtype)
    if kv == "int8":
        pools = [(_meta(9, page_size, h, d, dtype=torch.int8),
                  _meta(9, page_size, h)) for _ in range(2)]
    else:
        pools = [_meta(9, page_size, h, d, dtype=dtype) for _ in range(2)]
    return q, pools[0], pools[1], _meta(b, 3, dtype=torch.int32)


# ------------------------------------------------------------ the predicates
@pytest.mark.parametrize("d", ca.HEAD_DIMS)
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("fused", [True, False])
def test_flash_supported_takes_the_main_path_shapes(d, dtype, fused):
    q, k, v = _qkv_meta(d, dtype, fused=fused)
    assert ca.supported(q, k, v, causal=True)
    assert ca.supported(q, k, v, causal=True, backward=True)
    assert ca.supported(q, k, v, causal=False)


@pytest.mark.parametrize("d", REFUSED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_supported_refuses_other_head_dims(d, dtype):
    q, k, v = _qkv_meta(d, dtype)
    assert not ca.supported(q, k, v, causal=True)
    assert not ca.supported(q, k, v, causal=False, backward=True)
    # a direct call of the wrapper's check still raises
    with pytest.raises(ValueError, match="head_dim"):
        ca._check(q, k, v, causal=True)


def test_flash_supported_refuses_what_the_wrapper_refuses():
    q, k, v = _qkv_meta(64, torch.float32)
    assert not ca.supported(q, k[:, :32], v[:, :32], causal=True)  # sq != sk
    assert ca.supported(q, k[:, :32], v[:, :32], causal=False)
    h = _qkv_meta(64, torch.float16)
    assert ca.supported(*h, causal=True)                          # fp16
    f64 = _qkv_meta(64, torch.float64)
    assert not ca.supported(*f64, causal=True)                    # float64
    # 16-bit rows must be 16-byte aligned for TMA: an odd s stride is not
    for dtype in (torch.bfloat16, torch.float16):
        odd = _meta(2, 64, 4, 3 * 64 + 1, dtype=dtype)[..., :64]
        assert not ca.supported(odd, odd, odd, causal=True)
        assert ca.supported(odd.float(), odd.float(), odd.float(),
                            causal=True)


@pytest.mark.parametrize("d", cpa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 5)])
def test_paged_supported_takes_the_main_path_shapes(d, dtype, kv, kind, s):
    q, kp, vp, tables = _paged_meta(d, dtype, kv=kv, s=s)
    assert cpa.supported(q, kp, vp, tables, 16, kind)


@pytest.mark.parametrize("d", REFUSED_HEAD_DIMS)
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_supported_refuses_other_head_dims(d, kv):
    q, kp, vp, tables = _paged_meta(d, torch.bfloat16, kv=kv)
    assert not cpa.supported(q, kp, vp, tables, 16, "decode")
    assert not cpa.supported(q, kp, vp, tables, 16, "chunked")


@pytest.mark.parametrize("page_size", [1, 16, 64, 128, 256])
def test_paged_supported_takes_any_page_size(page_size):
    # every token resolves its own page in the kernels: no cap remains
    for kv in ("model", "int8"):
        for dtype in DTYPES:
            q, kp, vp, tables = _paged_meta(128, dtype, page_size, kv=kv)
            assert cpa.supported(q, kp, vp, tables, page_size, "decode")


def test_paged_supported_refuses_what_the_wrapper_refuses():
    q, kp, vp, tables = _paged_meta(64, torch.bfloat16)
    assert not cpa.supported(q, kp, vp, tables, 16, "prefill")    # kind
    assert not cpa.supported(q, kp, vp, tables, 8, "decode")      # page
    assert not cpa.supported(q, kp.float(), vp, tables, 16, "decode")
    assert not cpa.supported(q.half(), kp.half(), vp.half(), tables, 16,
                             "decode")
    assert not cpa.supported(q, kp, vp, tables[:2], 16, "decode")  # B
    _, ip, _, _ = _paged_meta(64, torch.bfloat16, kv="int8")
    assert not cpa.supported(q, ip, vp, tables, 16, "decode")     # mixed
    strided = _meta(9, 16, 4, 128, dtype=torch.bfloat16)[..., :64]
    assert not cpa.supported(q, strided, strided, tables, 16, "decode")


# ------------------------------------------------------------ the routing
@pytest.fixture
def no_kernel_route(monkeypatch):
    """Make every kernel-route function fail if a caller reaches it."""
    def boom(*args, **kwargs):
        raise AssertionError("a refused shape reached the kernel route")
    monkeypatch.setattr(fa, "flash_attention_fwd", boom)
    monkeypatch.setattr(fa, "flash_attention_bwd", boom)
    monkeypatch.setattr(cpa, "paged_attention", boom)


def _counts():
    return (ca.plain_calls, dict(cab.plain_calls), cpa.plain_calls)


@pytest.mark.parametrize("d", [16, 80])
def test_attention_bshd_routes_refused_shapes(no_kernel_route, d):
    rng = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 2, d).astype(np.float32))
               .requires_grad_() for _ in range(3))
    before = _counts()
    out = fa.attention_bshd(q, k, v, causal=True)
    ref, _ = ca.mha_fwd_reference(q.detach(), k.detach(), v.detach(),
                                  causal=True)
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    out.sum().backward()
    after = _counts()
    assert after[0] == before[0] + 2      # both forwards: ours and ref
    assert all(after[1][n] == before[1][n] + 1 for n in cab.KERNELS)
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        fa.attention_bshd(q, k, v, causal=True)
    assert ca.plain_calls == after[0] + 1


def test_prefill_flash_routes_refused_shapes(no_kernel_route):
    q = torch.randn(2, 7, 2, 32, generator=torch.Generator().manual_seed(0))
    before = ca.plain_calls
    out = fa.prefill_flash(q, q, q, 0.25)
    assert ca.plain_calls == before + 1 and out.shape == q.shape


def test_supported_shapes_still_take_the_kernel_route(monkeypatch):
    """On CPU tensors the wrapper itself runs the plain version; a shape
    the kernel takes is handed to the wrapper, not past it."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        spy(ca.flash_attention_fwd))
    monkeypatch.setattr(cpa, "paged_attention", spy(cpa.paged_attention))
    q = torch.randn(2, 8, 2, 64, generator=torch.Generator().manual_seed(1))
    fa.prefill_flash(q, q, q, 0.125)
    fa.attention_bshd(q, q, q, causal=True)
    kp = torch.randn(5, 4, 2, 64, generator=torch.Generator().manual_seed(2))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    ctx = torch.tensor([5, 3], dtype=torch.int32)
    tpa.paged_attention_update(q[:, :1], q[:, :1], q[:, :1], kp, kp.clone(),
                               tables, ctx, torch.ones(2, 1, dtype=torch.bool),
                               (ctx - 1)[:, None], page_size=4, kind="decode")
    assert seen == ["flash_attention_fwd", "flash_attention_fwd",
                    "paged_attention"]


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 4)])
def test_paged_attention_update_routes_refused_shapes(no_kernel_route, kv,
                                                      kind, s):
    rng = np.random.RandomState(s)
    b, h, d, ps, pps = 2, 2, 16, 4, 3
    pool = rng.randn(1 + b * pps, ps, h, d).astype(np.float32)
    if kv == "int8":
        kp, vp = (tuple(t.reshape(1 + b * pps, ps, *t.shape[1:])
                        for t in tpa.quantize_kv_rows(
                            torch.from_numpy(pool).reshape(-1, h, d)))
                  for _ in range(2))
    else:
        kp, vp = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               for _ in range(3))
    tables = torch.from_numpy(_tables(b, pps))
    start = torch.tensor([3, 5], dtype=torch.int32)
    positions = start[:, None] + torch.arange(s, dtype=torch.int32)[None]
    valid = torch.ones(b, s, dtype=torch.bool)
    ctx = start + s
    before = cpa.plain_calls
    out, _, _ = tpa.paged_attention_update(
        q, k, v, kp, vp, tables, ctx, valid, positions, page_size=ps,
        kind=kind)
    assert cpa.plain_calls == before + 1
    assert out.shape == (b, s, h, d) and bool(torch.isfinite(out).all())


# ------------------------------------------- gpt_tiny against the reference
def test_gpt_tiny_head_dim_is_refused():
    cfg = gpt_tiny()
    assert cfg.hidden_size // cfg.num_heads not in ca.HEAD_DIMS
    assert cfg.hidden_size // cfg.num_heads not in cpa.HEAD_DIMS


def test_gpt_tiny_decodes_through_the_plain_versions(no_kernel_route):
    """Prefill, decode steps and a verify window of the port's
    CachedDecoder (default: kernels on) against the reference's, with the
    kernel routes patched to fail: every call takes the plain versions."""
    jm, tm = make_pair(seed=4)
    b, window, ps, pps = 2, 8, 4, 8
    rng = np.random.RandomState(11)
    lens = np.array([6, 3], np.int32)
    ids = np.zeros((b, window), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 256, n)
    tables = _tables(b, pps)
    jd = JDecoder(jm, max_batch=b, page_size=ps, pages_per_seq=pps)
    td = CachedDecoder(tm, max_batch=b, page_size=ps, pages_per_seq=pps,
                       device="cpu")
    assert td.use_kernels
    jk, jv = jm.init_kv_pools(1 + b * pps, ps)
    tk, tv = tm.init_kv_pools(1 + b * pps, ps)
    before = _counts()
    jl, jk, jv, _ = jd.prefill(ids, lens, tables, jk, jv)
    tl, tk, tv = td.prefill(ids, lens, tables, tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    ctx = lens.copy()
    tok = np.asarray(jl).argmax(-1).astype(np.int64)
    for _ in range(4):
        live = np.ones(b, bool)
        jl, jk, jv, _ = jd.decode(tok, ctx, live, ctx + 1, tables, jk, jv)
        tl, tk, tv = td.decode(tok, ctx, live, ctx + 1, tables, tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int64)
        ctx = ctx + 1
    win = rng.randint(0, 256, (b, 3)).astype(np.int64)
    seg = np.array([3, 3], np.int32)
    jl, jk, jv, _ = jd.verify(win, ctx, seg, tables, jk, jv)
    tl, tk, tv = td.verify(win, ctx, seg, tables, tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    after = _counts()
    layers = gpt_tiny().num_layers
    assert after[0] == before[0] + layers              # the prefill
    assert after[2] == before[2] + 5 * layers          # 4 decodes, verify


def test_gpt_tiny_trains_through_the_plain_versions(no_kernel_route):
    """Two TrainStep steps of the port (kernels on by default) against the
    reference's, with the kernel routes patched to fail."""
    ids = _ids(seed=5)
    init = _arrays(_jax_model())
    jl, jp, _, _ = _jax_train(2, ids)
    before = _counts()
    pl, pp, _, _ = _port_train(init, 2, ids)
    after = _counts()
    layers = gpt_tiny().num_layers
    assert after[0] == before[0] + 2 * layers
    assert all(after[1][n] == before[1][n] + 2 * layers for n in cab.KERNELS)
    _assert_matches("gpt_tiny routed", (pl, pp), (jl, jp), init, steps=2)
