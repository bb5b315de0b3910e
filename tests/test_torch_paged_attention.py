"""Port parity: paged KV-cache plumbing and the paged-attention kernel's plain
version (paddle_tpu_torch/ops/{paged_attention,cuda_paged_attention}.py)
against the JAX package (ops/paged_attention.py and the Pallas kernel
ops/pallas_paged_attention.py in interpret mode).

Inputs are made from seeded numpy and handed to both packages, in float32.
Live rows are compared at atol 1e-5 (float32 sums in another order); dead
rows of the port are exactly zero (the JAX pure path leaves an average of
garbage there, so they are not compared with it). int8 pools: quantization
and the pools after a write are bit-identical to the reference's; attention
over them is held at atol/rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import pallas_paged_attention as jppa
from paddle_tpu_torch.ops import cuda_paged_attention as cpa
from paddle_tpu_torch.ops import paged_attention as tpa
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

H, D, PS = 4, 16, 8
ATOL = 1e-5


def _case(seed, b=3, p=4, s=1, kind="decode"):
    """Pools of unit-normal values (the trash page too), a shuffled table
    with a trash-page tail, ragged contexts and one dead row."""
    rng = np.random.RandomState(seed)
    num_pages = 1 + b * p
    kp = rng.randn(num_pages, PS, H, D).astype(np.float32)
    vp = rng.randn(num_pages, PS, H, D).astype(np.float32)
    q = rng.randn(b, s, H, D).astype(np.float32)
    tables = (1 + rng.permutation(b * p)).reshape(b, p).astype(np.int32)
    tables[1, 2:] = 0                           # trash-page tail
    if kind == "decode":
        ctx = np.array([PS * p, PS + 3] + [0] * (b - 2), np.int32)
        valid = (ctx > 0)[:, None].repeat(s, 1)
        positions = np.maximum(ctx - 1, 0)[:, None].repeat(s, 1)
    else:
        start = np.array([5, 2] + [0] * (b - 2), np.int32)
        seg = np.array([s, max(1, s - 2)] + [0] * (b - 2), np.int32)
        offs = np.arange(s, dtype=np.int32)[None]
        positions = (start[:, None] + offs).astype(np.int32)
        valid = offs < seg[:, None]
        ctx = (start + seg).astype(np.int32)
    return dict(q=q, kp=kp, vp=vp, tables=tables, ctx=ctx,
                valid=valid.astype(bool), positions=positions.astype(np.int32))


def _t(c):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}


def _live(c, kind):
    if kind == "decode":
        return (c["ctx"] > 0)[:, None].repeat(c["q"].shape[1], 1)
    return c["valid"] & (np.minimum(c["positions"], c["ctx"][:, None] - 1)
                         >= 0)


def test_flat_slots_write_gather_roundtrip_matches_jax():
    c = _case(0, b=2, p=3, s=PS * 3, kind="chunked")
    rng = np.random.RandomState(1)
    kv = rng.randn(2 * PS * 3, H, D).astype(np.float32)
    valid = rng.rand(2, PS * 3) > 0.3
    positions = np.broadcast_to(np.arange(PS * 3, dtype=np.int32),
                                (2, PS * 3)).copy()
    j_slots = np.asarray(jpa.flat_slots(jnp.asarray(c["tables"]),
                                        jnp.asarray(positions),
                                        jnp.asarray(valid), PS))
    t_slots = tpa.flat_slots(torch.from_numpy(c["tables"]),
                             torch.from_numpy(positions),
                             torch.from_numpy(valid), PS)
    np.testing.assert_array_equal(t_slots.numpy(), j_slots)
    # invalid positions land on the trash page, at their offset
    assert (j_slots[~valid] < PS).all()
    # unique live slots: both packages write the same pool
    live = valid.reshape(-1)
    flat = j_slots.reshape(-1)
    j_pool = np.asarray(jpa.write_pool(jnp.asarray(c["kp"]), flat[live],
                                       kv[live]))
    t_pool = torch.from_numpy(c["kp"].copy())
    out = tpa.write_pool(t_pool, torch.from_numpy(flat[live]),
                         torch.from_numpy(kv[live]))
    assert out is t_pool                        # in place
    np.testing.assert_array_equal(t_pool.numpy(), j_pool)
    j_g = np.asarray(jpa.gather_pool(jnp.asarray(j_pool),
                                     jnp.asarray(c["tables"])))
    t_g = tpa.gather_pool(t_pool, torch.from_numpy(c["tables"]))
    np.testing.assert_array_equal(t_g.numpy(), j_g)
    assert t_g.shape == (2, 3 * PS, H, D)


@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 5),
                                    ("chunked", 11)])
def test_pure_attention_matches_jax(kind, s):
    c = _case(2 + s, s=s, kind=kind)
    t = _t(c)
    scale = 1.0 / np.sqrt(D)
    ks_j = jpa.gather_pool(jnp.asarray(c["kp"]), jnp.asarray(c["tables"]))
    vs_j = jpa.gather_pool(jnp.asarray(c["vp"]), jnp.asarray(c["tables"]))
    ks_t = tpa.gather_pool(t["kp"], t["tables"])
    vs_t = tpa.gather_pool(t["vp"], t["tables"])
    if kind == "decode":
        j = jpa._decode_attention(jnp.asarray(c["q"]), ks_j, vs_j,
                                  jnp.asarray(c["ctx"]), scale)
        o = tpa._decode_attention(t["q"], ks_t, vs_t, t["ctx"].long(), scale)
    else:
        j = jpa._chunked_attention(jnp.asarray(c["q"]), ks_j, vs_j,
                                   jnp.asarray(c["positions"]),
                                   jnp.asarray(c["valid"]), scale)
        o = tpa._chunked_attention(t["q"], ks_t, vs_t, t["positions"].long(),
                                   t["valid"], scale)
    # the pure paths agree on every row, dead rows included
    np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 5),
                                    ("chunked", 9)])
def test_kernel_plain_version_matches_jax_pallas_interpret(kind, s):
    c = _case(7 + s, s=s, kind=kind)
    t = _t(c)
    scale = 1.0 / np.sqrt(D)
    j = np.asarray(jppa.paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["ctx"]),
        jnp.asarray(c["valid"].astype(np.int32)),
        jnp.asarray(c["positions"]), page_size=PS, kind=kind, scale=scale))
    before = cpa.plain_calls
    o = cpa.paged_attention(t["q"], t["kp"], t["vp"], t["tables"], t["ctx"],
                            t["valid"], t["positions"], page_size=PS,
                            kind=kind, scale=scale).numpy()
    assert cpa.plain_calls == before + 1     # CPU tensors: the plain version
    live = _live(c, kind)
    assert live.any() and (~live).any()
    np.testing.assert_allclose(o[live], j[live], atol=ATOL, rtol=0)
    assert np.all(o[~live] == 0.0)


def test_paged_attention_update_writes_then_attends():
    """Decode includes self: the token written by this call is visible."""
    c = _case(3, kind="decode")
    t = _t(c)
    b = c["q"].shape[0]
    rng = np.random.RandomState(4)
    k_new = torch.from_numpy(rng.randn(b, 1, H, D).astype(np.float32))
    v_new = torch.from_numpy(rng.randn(b, 1, H, D).astype(np.float32))
    kp, vp = t["kp"].clone(), t["vp"].clone()
    out, kp2, vp2 = tpa.paged_attention_update(
        t["q"], k_new, v_new, kp, vp, t["tables"], t["ctx"], t["valid"],
        t["positions"], page_size=PS, kind="decode")
    assert kp2 is kp and vp2 is vp
    j_out, j_kp, _ = jpa.paged_attention_update(
        jnp.asarray(c["q"]), jnp.asarray(k_new.numpy()),
        jnp.asarray(v_new.numpy()), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["tables"]), jnp.asarray(c["ctx"]),
        jnp.asarray(c["valid"]), jnp.asarray(c["positions"]), page_size=PS,
        kind="decode", use_pallas=False)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(j_kp))
    live = _live(c, "decode")
    np.testing.assert_allclose(out.numpy()[live], np.asarray(j_out)[live],
                               atol=ATOL, rtol=0)


# ------------------------------------------------------- int8 pools
def _quant_rows(seed, n=40):
    """Rows of mixed scales, an all-zero row, a row of one repeated value,
    and rows built so that x / scale lands on .5 exactly (ties, which both
    packages round half to even)."""
    rng = np.random.RandomState(seed)
    kv = (rng.randn(n, H, D) * rng.choice([1e-3, 1.0, 30.0], (n, H, 1))
          ).astype(np.float32)
    kv[0] = 0.0
    kv[1] = 2.5
    kv[2, :, 0] = 127.0
    kv[2, :, 1:] = np.arange(D - 1) % 7 - 3.5
    return kv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bit_identical_to_jax(seed):
    kv = _quant_rows(seed)
    jq, js = jpa.quantize_kv_rows(jnp.asarray(kv))
    tq, ts = tpa.quantize_kv_rows(torch.from_numpy(kv))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[0] == 0).all() and (tq[0] == 0).all()
    jd = jpa.dequantize_kv(jq, js)
    td = tpa.dequantize_kv(tq, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[0].abs().max() == 0           # zero rows come back exactly
    # one rounding step of the int8 grid: |x - dq(q(x))| <= scale / 2
    err = (td - torch.from_numpy(kv)).abs().amax(-1)
    assert bool((err <= ts / 2 * (1 + 1e-6) + 1e-30).all())


def _int8_pools(c):
    """The case's float pools quantized into (values, scales) tuples, for
    both packages."""
    out = {}
    for name in ("kp", "vp"):
        n = c[name].shape[0] * PS
        q, sc = jpa.quantize_kv_rows(jnp.asarray(
            c[name].reshape(n, H, D)))
        out[name] = (np.asarray(q).reshape(-1, PS, H, D),
                     np.asarray(sc).reshape(-1, PS, H))
    return out


def _tt(pool):
    return tuple(torch.from_numpy(np.array(a)) for a in pool)  # owned copies


def _jt(pool):
    return tuple(jnp.asarray(a) for a in pool)


def test_int8_write_gather_roundtrip_matches_jax():
    c = _case(5, b=2, p=3, s=PS * 3, kind="chunked")
    pools = _int8_pools(c)
    rng = np.random.RandomState(6)
    n = 2 * PS * 3
    kv = rng.randn(n, H, D).astype(np.float32)
    valid = rng.rand(2, PS * 3) > 0.3
    positions = np.broadcast_to(np.arange(PS * 3, dtype=np.int32),
                                (2, PS * 3)).copy()
    slots = np.asarray(jpa.flat_slots(jnp.asarray(c["tables"]),
                                      jnp.asarray(positions),
                                      jnp.asarray(valid), PS)).reshape(-1)
    live = valid.reshape(-1)
    j_pool = jpa.write_pool(_jt(pools["kp"]), jnp.asarray(slots[live]),
                            jnp.asarray(kv[live]))
    t_pool = _tt(pools["kp"])
    out = tpa.write_pool(t_pool, torch.from_numpy(slots[live]),
                         torch.from_numpy(kv[live]))
    assert out is t_pool and tpa.is_quantized_pool(out)     # in place
    for got, want in zip(t_pool, j_pool):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tables = jnp.asarray(c["tables"])
    for dt_j, dt_t in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        j_g = np.asarray(jpa.gather_pool(j_pool, tables, out_dtype=dt_j)
                         .astype(jnp.float32))
        t_g = tpa.gather_pool(t_pool, torch.from_numpy(c["tables"]),
                              out_dtype=dt_t)
        assert t_g.dtype == (dt_t or torch.float32)
        np.testing.assert_array_equal(t_g.float().numpy(), j_g)


def test_int8_bytes_and_dtype_marker():
    assert tpa.resolve_kv_dtype("int8") == "int8"
    assert tpa.resolve_kv_dtype("") is None
    assert tpa.resolve_kv_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="kv dtype"):
        tpa.resolve_kv_dtype("int4")
    for dt in ("", "float32", "bfloat16", "int8"):
        assert tpa.kv_pool_bytes(7, 16, 4, 64, dt) == \
            jpa.kv_pool_bytes(7, 16, 4, 64, dt)
    assert tpa.kv_pool_bytes(1, 1, 16, 128, "int8") == 16 * (128 + 4)


@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 5),
                                    ("chunked", 9)])
def test_int8_plain_version_matches_jax_pallas_interpret(kind, s):
    c = _case(17 + s, s=s, kind=kind)
    pools = _int8_pools(c)
    t = _t(c)
    scale = 1.0 / np.sqrt(D)
    j = np.asarray(jppa.paged_attention(
        jnp.asarray(c["q"]), _jt(pools["kp"]), _jt(pools["vp"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["ctx"]),
        jnp.asarray(c["valid"].astype(np.int32)),
        jnp.asarray(c["positions"]), page_size=PS, kind=kind, scale=scale))
    before = cpa.plain_calls
    o = cpa.paged_attention(t["q"], _tt(pools["kp"]), _tt(pools["vp"]),
                            t["tables"], t["ctx"], t["valid"],
                            t["positions"], page_size=PS, kind=kind,
                            scale=scale).numpy()
    assert cpa.plain_calls == before + 1     # CPU tensors: the plain version
    live = _live(c, kind)
    assert live.any() and (~live).any()
    np.testing.assert_allclose(o[live], j[live], atol=ATOL, rtol=ATOL)
    assert np.all(o[~live] == 0.0)


@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 6)])
def test_int8_update_matches_jax_pure_path(kind, s):
    """Write (quantize) then attend, through both packages' plain paths:
    the pools afterwards are bit-identical, and live rows agree; the tuple
    pools come back as the same objects."""
    c = _case(31 + s, s=s, kind=kind)
    pools = _int8_pools(c)
    t = _t(c)
    b = c["q"].shape[0]
    rng = np.random.RandomState(40 + s)
    k_new = rng.randn(b, s, H, D).astype(np.float32)
    v_new = rng.randn(b, s, H, D).astype(np.float32)
    kp, vp = _tt(pools["kp"]), _tt(pools["vp"])
    out, kp2, vp2 = tpa.paged_attention_update(
        t["q"], torch.from_numpy(k_new), torch.from_numpy(v_new), kp, vp,
        t["tables"], t["ctx"], t["valid"], t["positions"], page_size=PS,
        kind=kind)
    assert kp2 is kp and vp2 is vp
    j_out, j_kp, j_vp = jpa.paged_attention_update(
        jnp.asarray(c["q"]), jnp.asarray(k_new), jnp.asarray(v_new),
        _jt(pools["kp"]), _jt(pools["vp"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["ctx"]), jnp.asarray(c["valid"]),
        jnp.asarray(c["positions"]), page_size=PS, kind=kind,
        use_pallas=False)
    live_slot = np.asarray(jpa.flat_slots(
        jnp.asarray(c["tables"]), jnp.asarray(c["positions"]),
        jnp.asarray(c["valid"]), PS)).reshape(-1) >= PS
    for got, want in ((kp, j_kp), (vp, j_vp)):
        for g, w in zip(got, want):
            g = g.numpy().reshape(-1, *g.shape[2:])
            w = np.asarray(w).reshape(g.shape)
            # the trash page takes colliding writes in no agreed order
            np.testing.assert_array_equal(g[PS:], w[PS:])
    assert live_slot.any()
    live = _live(c, kind)
    np.testing.assert_allclose(out.numpy()[live], np.asarray(j_out)[live],
                               atol=ATOL, rtol=ATOL)


# ------------------------------------- the CUDA kernels' arithmetic, emulated
# The bf16-query kernels of csrc/paged_attention.cu reorder the reference's
# maths; these tests emulate the two reorderings in torch (float32) on the
# same seeded inputs and hold them against the JAX package's kernel in
# interpret mode:
# - the split-context decode kernel computes a softmax state (m, l, acc) per
#   chunk of the context, in the exp2 domain, and the last block merges them;
#   chunks with no live token hold (-inf, 0, 0);
# - the window kernel runs an online softmax over context tiles, each tile
#   split among warps whose states merge at the end; a window of at most 16
#   rows also splits its context into blocks of tiles, each block's state a
#   partial merged as the decode kernel's are;
# - both factor int8's K scale out of the dot (s = s_k * (q . k_int)), fold
#   the V scale into p, and feed P to the PV product as bf16 hi + lo parts.
# Emulated chunk and tile sizes are small (8 tokens, warps of 4) so that the
# 32-slot tables span several of them, and some hold no live token.
# Tolerances: int8 pools with q rounded to bf16 (the kernel's q type) fed to
# both as float32, atol/rtol 1e-5 (float32 sums in another order; P keeps
# ~16 bits); bf16 pools, the reference in bf16 (it rounds p and its output to
# bf16), atol 2e-2 on outputs of magnitude below 3 (bf16 rounding of the
# reference's p and output, 2^-8 relative).
LOG2E = 1.4426950408889634
EMU_TILE, EMU_WARPS, EMU_CHUNK = 8, 2, 8


def _bf16(x):
    return np.asarray(torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float())


def _raw_context(pool, tables):
    """The gathered pool values as float32 (int8 values undequantized) and
    their per-token scales (ones for a float pool): [B, T, H, D], [B, H, T]."""
    if tpa.is_quantized_pool(pool):
        vals = tpa._gather_flat(pool[0], tables).float()
        sc = tpa._gather_flat(pool[1], tables).float()
    else:
        vals = tpa._gather_flat(pool, tables).float()
        sc = torch.ones(vals.shape[:3])
    return vals, sc.permute(0, 2, 1)


def _n_live(ctx, valid, positions, kind, s, cap):
    ctx = ctx.long().clamp(0, cap)
    if kind == "decode":
        return ctx[:, None].expand(-1, s)
    n = torch.minimum(positions.long() + 1, ctx[:, None])
    return torch.where(valid, n, torch.zeros_like(n)).clamp(min=0)


def _hi_lo(p):
    """p through bf16 hi + lo parts, as the kernels feed P to the PV
    product."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def _scores(ctx_, t0, t1):
    """Scores of tokens [t0, t1) in the exp2 domain, the K scale factored
    out of the dot, -inf past each row's live prefix: [B, S, H, T']."""
    q, k, ks, n, scale = (ctx_[x] for x in ("q", "k", "ks", "n", "scale"))
    s = torch.einsum("bshd,bthd->bsht", q, k[:, t0:t1])
    s = s * (scale * LOG2E) * ks[:, None, :, t0:t1]
    t = torch.arange(t0, t1)
    return torch.where(t < n[:, :, None, None], s, torch.tensor(-np.inf))


def _pv(ctx_, p, t0, t1):
    """acc contribution of p over tokens [t0, t1): the V scale folded into
    p, P as hi + lo."""
    pv = _hi_lo(p * ctx_["vs"][:, None, :, t0:t1])
    return torch.einsum("bsht,bthd->bshd", pv, ctx_["v"][:, t0:t1])


def _chunk_state(ctx_, t0, t1):
    s = _scores(ctx_, t0, t1)
    m = s.amax(-1)
    p = torch.exp2(s - torch.where(m == -np.inf, 0.0, m)[..., None])
    return m, p.sum(-1), _pv(ctx_, p, t0, t1)


def _merge(states):
    """Merge softmax states (m, l, acc): weights exp2(m - max m), 0 for a
    state with no live token; a row with none anywhere writes zeros."""
    ms = torch.stack([m for m, _, _ in states])
    top = ms.amax(0)
    w = torch.where(top == -np.inf, 0.0,
                    torch.exp2(ms - torch.where(top == -np.inf, 0.0, top)))
    den = sum(wi * l for wi, (_, l, _) in zip(w, states))
    num = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, states))
    return torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None],
                       torch.zeros_like(num))


def _emu_ctx(c, k_pool, v_pool, kind):
    t = _t(c)
    k, ks = _raw_context(k_pool, t["tables"])
    v, vs = _raw_context(v_pool, t["tables"])
    s = c["q"].shape[1]
    n = _n_live(t["ctx"], t["valid"], t["positions"], kind, s, k.shape[1])
    return {"q": torch.from_numpy(_bf16(c["q"])), "k": k, "ks": ks, "v": v,
            "vs": vs, "n": n, "scale": 1.0 / np.sqrt(D)}


def _emulate_split_decode(ctx_, chunk=EMU_CHUNK, keep_empty=False):
    """The decode kernel: one state per chunk of the context, merged.
    Chunks at or past the row's context are not merged (their blocks exit
    at once) unless ``keep_empty``."""
    t_cap = ctx_["k"].shape[1]
    n_max = int(ctx_["n"].max())
    ends = range(0, t_cap if keep_empty else n_max, chunk)
    return _merge([_chunk_state(ctx_, t0, min(t0 + chunk, t_cap))
                   for t0 in ends])


def _warp_online(ctx_, starts, share):
    """One warp's online softmax over its ``share`` tokens from each tile
    start in ``starts``: (m, l, acc)."""
    shape = ctx_["q"].shape
    m = torch.full(shape[:3], -np.inf)
    lsum = torch.zeros(shape[:3])
    acc = torch.zeros(shape)
    for t0 in starts:
        t1 = t0 + share
        s = _scores(ctx_, t0, t1)
        m_new = torch.maximum(m, s.amax(-1))
        use = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.exp2(m - use)
        p = torch.exp2(s - use[..., None])
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _pv(ctx_, p, t0, t1)
        m = m_new
    return m, lsum, acc


def _emulate_window(ctx_, tile=EMU_TILE, warps=EMU_WARPS, block_tiles=None):
    """The window kernel: each warp's online softmax over its share of
    every context tile up to the longest live prefix, the warps' states
    merged; with ``block_tiles`` (windows of at most 16 rows) the context
    is split into blocks of that many tiles, each block's merged state a
    partial, and the partials merged as the decode kernel's are."""
    share = tile // warps
    kv_end = int(ctx_["n"].max())
    n_tiles = -(-kv_end // tile)
    per = block_tiles or n_tiles
    partials = []
    for tb in range(0, n_tiles, per):
        starts = [t * tile for t in range(tb, min(tb + per, n_tiles))]
        warp_states = [_warp_online(ctx_, [t0 + w * share for t0 in starts],
                                    share) for w in range(warps)]
        out = _merge(warp_states)
        if block_tiles is None:
            return out
        # the block's partial: its merged state, unnormalised
        ms = torch.stack([m for m, _, _ in warp_states]).amax(0)
        use = torch.where(ms == -np.inf, 0.0, ms)
        w8 = [torch.exp2(m - use) for m, _, _ in warp_states]
        lsum = sum(w * lw for w, (_, lw, _) in zip(w8, warp_states))
        acc = sum(w[..., None] * a for w, (_, _, a) in zip(w8, warp_states))
        partials.append((ms, lsum, acc))
    return _merge(partials)


def _jax_kernel(c, k_pool, v_pool, kind, q):
    return np.asarray(jppa.paged_attention(
        jnp.asarray(q), k_pool, v_pool, jnp.asarray(c["tables"]),
        jnp.asarray(c["ctx"]), jnp.asarray(c["valid"].astype(np.int32)),
        jnp.asarray(c["positions"]), page_size=PS, kind=kind,
        scale=1.0 / np.sqrt(q.shape[-1]))).astype(np.float32)


def _pools_both(c, kv):
    """(torch K, torch V, jax K, jax V, jax q, atol, rtol) for bf16 or int8
    pools; q rounded to bf16 either way."""
    if kv == "int8":
        p = _int8_pools(c)
        return (_tt(p["kp"]), _tt(p["vp"]), _jt(p["kp"]), _jt(p["vp"]),
                _bf16(c["q"]), 1e-5, 1e-5)
    kb, vb = (torch.from_numpy(c[x]).to(torch.bfloat16) for x in ("kp", "vp"))
    return (kb, vb, jnp.asarray(c["kp"], jnp.bfloat16),
            jnp.asarray(c["vp"], jnp.bfloat16),
            jnp.asarray(c["q"], jnp.bfloat16), 2e-2, 0.0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_split_context_decode_emulation_matches_jax_pallas_interpret(kv):
    c = _case(51, b=3, p=4, s=1, kind="decode")
    kp, vp, jk, jv, jq, atol, rtol = _pools_both(c, kv)
    ctx_ = _emu_ctx(c, kp, vp, "decode")
    got = _emulate_split_decode(ctx_).numpy()
    want = _jax_kernel(c, jk, jv, "decode", jq)
    live = _live(c, "decode")
    assert live.any() and (~live).any()
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=rtol)
    assert np.all(got[~live] == 0.0)
    # the 32-slot row spans four chunks, the 11-slot row two
    assert int(ctx_["n"].max()) > 3 * EMU_CHUNK


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_split_merge_of_chunks_with_no_live_token(kv):
    """Chunks past a row's context contribute (m = -inf, l = 0, acc = 0):
    merged in, they change nothing and make no NaN, also for a dead
    lane."""
    c = _case(52, b=3, p=4, s=1, kind="decode")
    kp, vp = _pools_both(c, kv)[:2]
    ctx_ = _emu_ctx(c, kp, vp, "decode")
    m, lsum, acc = _chunk_state(ctx_, 3 * EMU_CHUNK, 4 * EMU_CHUNK)
    short = ctx_["n"][:, 0] <= 3 * EMU_CHUNK
    assert short.any() and bool((m[short] == -np.inf).all())
    assert bool((lsum[short] == 0).all()) and bool((acc[short] == 0).all())
    got = _emulate_split_decode(ctx_, keep_empty=True)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(),
                                  _emulate_split_decode(ctx_).numpy())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("kind,s", [("chunked", 5), ("chunked", 9),
                                    ("decode", 1)])
@pytest.mark.parametrize("block_tiles", [None, 2])
def test_window_emulation_matches_jax_pallas_interpret(kv, kind, s,
                                                       block_tiles):
    c = _case(53 + s, b=3, p=4, s=s, kind=kind)
    kp, vp, jk, jv, jq, atol, rtol = _pools_both(c, kv)
    ctx_ = _emu_ctx(c, kp, vp, kind)
    got = _emulate_window(ctx_, block_tiles=block_tiles).numpy()
    want = _jax_kernel(c, jk, jv, kind, jq)
    live = _live(c, kind)
    assert live.any() and (~live).any()
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=rtol)
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_emulations_match_the_plain_version(kv):
    """Both reorderings against the port's own plain version (float
    softmax over dequantized K/V) on bf16-rounded q: atol/rtol 1e-5, the
    hi + lo split keeping P to ~16 bits."""
    for kind, s in (("decode", 1), ("chunked", 7)):
        c = _case(60 + s, b=3, p=4, s=s, kind=kind)
        kp, vp = _pools_both(c, kv)[:2]
        ctx_ = _emu_ctx(c, kp, vp, kind)
        t = _t(c)
        want = cpa.paged_attention_reference(
            ctx_["q"], kp, vp, t["tables"], t["ctx"], t["valid"],
            t["positions"], page_size=PS, kind=kind,
            scale=1.0 / np.sqrt(D)).numpy()
        emulated = [_emulate_window(ctx_), _emulate_window(ctx_,
                                                          block_tiles=2)]
        if kind == "decode":
            emulated.append(_emulate_split_decode(ctx_))
        for got in emulated:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)


# ------------------------------ the float32-query kernels' arithmetic, emulated
# float32 queries take two kernels of csrc/paged_attention.cu:
# - the split-context decode kernel (one decode row a sequence) in exact
#   float FMAs: a softmax state per chunk of the context (64 tokens over
#   float pools, 128 over int8), in the exp2 domain, merged;
# - the window kernel in 3xTF32 on the tensor cores: each float split into
#   TF32 hi + lo (the flash forward tests' helpers), three products an
#   8-wide step, small terms first, or two over int8 pools (an int8 value is
#   exact in TF32: q_lo k + q_hi k, p_lo v + p_hi v); each 8-dim step of
#   Q K^T summed from zero and joined to the score in one add, each context
#   tile's P V summed from zero and joined to the output once, after the
#   rescale; the scale after the dot and the max in natural units. Windows
#   of at most 16 rows take 64-token tiles split among four warps of 16
#   tokens, their states merged, and split the context into blocks of
#   eight tiles whose partial states the combine kernel merges; longer
#   windows take 32-token tiles, one warp over all of each.
# The emulations (the tensor cores' truncating sum inside a step is not
# modelled) are held at the kernels phase's float32 limit, atol/rtol 2e-5,
# against the JAX kernel in interpret mode and the port's plain version,
# over float and int8 pools, at D 64 and 128, with ragged contexts over
# several tiles and chunks; one TF32 product alone must fail that limit.
# Sizes: 4 rows (one dead) of 2 heads over 160-slot tables.
from test_torch_flash_attention import _split  # noqa: E402

F32_TOL = 2e-5
F32_H, F32_P = 2, 20
DEC_CHUNK = {"float": 64, "int8": 128}
SPLIT_TOK, WIDE_TOK, WARPS, SPLIT_TILES = 64, 32, 4, 8


def _case32(seed, d, kind, s):
    """[4, s] rows of F32_H heads over F32_P pages a row: ragged contexts
    over several 64-token tiles and decode chunks, a short row, one dead
    row; chunked windows start mid-context (one partly valid)."""
    rng = np.random.RandomState(seed)
    b, p, h = 4, F32_P, F32_H
    num_pages = 1 + b * p
    kp = rng.randn(num_pages, PS, h, d).astype(np.float32)
    vp = rng.randn(num_pages, PS, h, d).astype(np.float32)
    q = rng.randn(b, s, h, d).astype(np.float32)
    tables = (1 + rng.permutation(b * p)).reshape(b, p).astype(np.int32)
    cap = PS * p
    if kind == "decode":
        ctx = np.array([cap, 75, 3, 0], np.int32)
        valid = (ctx > 0)[:, None].repeat(s, 1)
        positions = np.maximum(ctx - 1, 0)[:, None].repeat(s, 1)
    else:
        start = np.array([cap - s - 1, 70, 2, 0], np.int32)
        seg = np.array([s, max(1, s - 3), max(1, s // 2), 0], np.int32)
        offs = np.arange(s, dtype=np.int32)[None]
        positions = start[:, None] + offs
        valid = offs < seg[:, None]
        ctx = (start + seg).astype(np.int32)
    tables[2, 1:] = 0                           # trash-page tail
    return dict(q=q, kp=kp, vp=vp, tables=tables, ctx=ctx,
                valid=valid.astype(bool), positions=positions.astype(np.int32))


def _pools32(c, kv):
    """(torch K, torch V, jax K, jax V) over float or int8 pools."""
    if kv == "int8":
        n = c["kp"].shape[0] * PS
        h, d = c["kp"].shape[2:]
        out = []
        for name in ("kp", "vp"):
            qv, sc = jpa.quantize_kv_rows(jnp.asarray(c[name].reshape(n, h,
                                                                      d)))
            out.append((np.asarray(qv).reshape(-1, PS, h, d),
                        np.asarray(sc).reshape(-1, PS, h)))
        return _tt(out[0]), _tt(out[1]), _jt(out[0]), _jt(out[1])
    return (torch.from_numpy(c["kp"].copy()), torch.from_numpy(c["vp"].copy()),
            jnp.asarray(c["kp"]), jnp.asarray(c["vp"]))


def _f32_ctx(c, k_pool, v_pool, kind):
    t = _t(c)
    k, ks = _raw_context(k_pool, t["tables"])
    v, vs = _raw_context(v_pool, t["tables"])
    s = c["q"].shape[1]
    n = _n_live(t["ctx"], t["valid"], t["positions"], kind, s, k.shape[1])
    return {"q": t["q"], "k": k, "ks": ks, "v": v, "vs": vs, "n": n,
            "scale": 1.0 / np.sqrt(c["q"].shape[-1]),
            "exact": tpa.is_quantized_pool(k_pool)}


def _tc(a, b, products):
    """a @ b on the tensor cores: 8-wide steps of the reduced index, each
    step's products summed from zero (3: a_lo b_hi + a_hi b_lo + a_hi b_hi;
    2: b exact in TF32, a_lo b + a_hi b; 1: a_hi b_hi alone), the steps
    accumulated in float32."""
    pad = -a.shape[-1] % 8
    if pad:   # a partial last step: zero terms
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = _split(a), _split(b)

    def steps(x, y):   # [steps, ..., M, N]: each step's products alone
        xs = x.unflatten(-1, (-1, 8))
        ys = y.unflatten(-2, (-1, 8))
        return torch.einsum("...mkc,...kcn->k...mn", xs, ys)

    if products == 3:
        step = steps(al, bh) + steps(ah, bl) + steps(ah, bh)
    elif products == 2:
        step = steps(al, b) + steps(ah, b)
    else:
        step = steps(ah, bh)
    acc = step[0]
    for k in range(1, step.shape[0]):
        acc = acc + step[k]
    return acc


def _f32_warp(ctx_, slices, products):
    """One warp's online softmax over its token ``slices`` [(t0, t1)]:
    (m natural, l, acc), [B, S, H] and [B, S, H, D]."""
    q, k, v = (ctx_[x].transpose(1, 2) for x in ("q", "k", "v"))  # [B, H, .]
    shape = ctx_["q"].shape
    m = torch.full(shape[:3], -np.inf)
    lsum = torch.zeros(shape[:3])
    acc = torch.zeros(shape)
    for t0, t1 in slices:
        # the kernel zero-fills a tile's rows past the context: no scores
        t1 = min(t1, k.shape[2])
        if t0 >= t1:
            continue
        raw = _tc(q, k[:, :, t0:t1].transpose(-1, -2), products)  # [B,H,S,T]
        x = raw.transpose(1, 2) * ctx_["scale"] * ctx_["ks"][:, None, :, t0:t1]
        t = torch.arange(t0, t1)
        x = torch.where(t < ctx_["n"][:, :, None, None], x,
                        torch.tensor(-np.inf))
        # fmaxf skips a NaN score; p takes it
        m_new = torch.maximum(m, x.masked_fill(x.isnan(), -np.inf).amax(-1))
        use = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.exp2((m - use) * LOG2E)
        p = torch.exp2(x * LOG2E - (use * LOG2E)[..., None])
        lsum = lsum * alpha + p.sum(-1)
        pv = p * ctx_["vs"][:, None, :, t0:t1]
        tile = _tc(pv.transpose(1, 2), v[:, :, t0:t1], products)
        acc = acc * alpha[..., None] + tile.transpose(1, 2)
        m = m_new
    return m, lsum, acc


def _f32_merge(states, log2=False):
    """Merge softmax states (m, l, acc) with weights 2^((m - max m) log2 e)
    (m already in log2 units with ``log2``), 0 for a state with no live
    token: (max m, den, num)."""
    ms = torch.stack([m for m, _, _ in states])
    top = ms.amax(0)
    scale = 1.0 if log2 else LOG2E
    w = torch.where(top == -np.inf, 0.0, torch.exp2(
        (ms - torch.where(top == -np.inf, 0.0, top)[None]) * scale))
    den = sum(wi * l for wi, (_, l, _) in zip(w, states))
    num = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, states))
    return top, den, num


def _finish(den, num):
    """den is 0 only for a row with no live token; a NaN den stays NaN."""
    return torch.where(den[..., None] != 0, num / den[..., None],
                       torch.zeros_like(num))


def _emulate_f32_window(ctx_, products=None, block_tiles=SPLIT_TILES):
    """The float32 window kernel: 16-row windows in split mode (64-token
    tiles, four warps of 16 tokens, blocks of ``block_tiles`` tiles merged
    as partials), longer windows over 32-token tiles, one warp each."""
    products = products or (2 if ctx_["exact"] else 3)
    kv_end = int(ctx_["n"].max())
    if ctx_["q"].shape[1] > 16:
        m, lsum, acc = _f32_warp(ctx_, [(t, t + WIDE_TOK) for t in
                                        range(0, kv_end, WIDE_TOK)], products)
        return _finish(lsum, acc)
    n_tiles = -(-kv_end // SPLIT_TOK)
    share = SPLIT_TOK // WARPS
    parts = []
    for tb in range(0, n_tiles, block_tiles):
        starts = [t * SPLIT_TOK for t in range(tb, min(tb + block_tiles,
                                                       n_tiles))]
        parts.append(_f32_merge([_f32_warp(
            ctx_, [(t0 + w * share, t0 + (w + 1) * share) for t0 in starts],
            products) for w in range(WARPS)]))
    if len(parts) == 1:
        return _finish(*parts[0][1:])
    # the combine kernel: the parts' m in log2 units
    return _finish(*_f32_merge([(m * LOG2E, den, num)
                                for m, den, num in parts], log2=True)[1:])


def _emulate_f32_decode(ctx_, keep_empty=False):
    """The decode kernel over float32 q: exact float sums (the order of the
    dot products is not modelled), a state per chunk in the exp2 domain,
    the K scale out of the dot and the V scale folded into p, merged. Chunks
    past every row's context are merged too with ``keep_empty``."""
    chunk = DEC_CHUNK["int8" if ctx_["exact"] else "float"]
    t_cap = ctx_["k"].shape[1]
    n = ctx_["n"]
    end = t_cap if keep_empty else int(n.max())
    states = []
    for t0 in range(0, end, chunk):
        t1 = min(t0 + chunk, t_cap)
        s = torch.einsum("bshd,bthd->bsht", ctx_["q"], ctx_["k"][:, t0:t1])
        s = s * (ctx_["scale"] * LOG2E) * ctx_["ks"][:, None, :, t0:t1]
        t = torch.arange(t0, t1)
        s = torch.where(t < n[:, :, None, None], s, torch.tensor(-np.inf))
        m = s.masked_fill(s.isnan(), -np.inf).amax(-1)
        p = torch.exp2(s - torch.where(m == -np.inf, 0.0, m)[..., None])
        pv = p * ctx_["vs"][:, None, :, t0:t1]
        states.append((m, p.sum(-1), torch.einsum(
            "bsht,bthd->bshd", pv, ctx_["v"][:, t0:t1])))
    return _finish(*_f32_merge(states, log2=True)[1:])


def _check_f32(got, want, live):
    np.testing.assert_allclose(got[live], want[live], atol=F32_TOL,
                               rtol=F32_TOL)
    assert np.all(got[~live] == 0.0)


F32_WINDOWS = [("chunked", 5), ("chunked", 20), ("decode", 3)]


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,s", F32_WINDOWS)
def test_f32_window_emulation_matches_jax_pallas_interpret(kv, d, kind, s):
    """The 3xTF32 window kernel (split mode at S=5 and the [4, 3] decode
    window, 64-row mode at S=20) against the reference's kernel."""
    c = _case32(80 + s + d, d, kind, s)
    kp, vp, jk, jv = _pools32(c, kv)
    ctx_ = _f32_ctx(c, kp, vp, kind)
    want = _jax_kernel(c, jk, jv, kind, c["q"])
    live = _live(c, kind)
    assert live.any() and (~live).any()
    _check_f32(_emulate_f32_window(ctx_).numpy(), want, live)
    # the rows span several tiles
    assert int(ctx_["n"].max()) > 2 * SPLIT_TOK


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_decode_emulation_matches_jax_pallas_interpret(kv, d):
    c = _case32(90 + d, d, "decode", 1)
    kp, vp, jk, jv = _pools32(c, kv)
    ctx_ = _f32_ctx(c, kp, vp, "decode")
    want = _jax_kernel(c, jk, jv, "decode", c["q"])
    live = _live(c, "decode")
    _check_f32(_emulate_f32_decode(ctx_).numpy(), want, live)
    # the long row spans two or three chunks, the short rows one
    assert int(ctx_["n"].max()) > DEC_CHUNK[kv]


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_f32_emulations_match_the_plain_version(kv):
    """Every float32 emulation against the port's plain version (float
    softmax over dequantized K/V): the split window with blocks of one tile
    (partials merged by the combine step) and of eight, the 64-row window,
    the decode kernel."""
    for kind, s in (("decode", 1), ("chunked", 7), ("chunked", 24),
                    ("decode", 2)):
        c = _case32(100 + s, 64, kind, s)
        kp, vp = _pools32(c, kv)[:2]
        ctx_ = _f32_ctx(c, kp, vp, kind)
        t = _t(c)
        want = cpa.paged_attention_reference(
            t["q"], kp, vp, t["tables"], t["ctx"], t["valid"], t["positions"],
            page_size=PS, kind=kind, scale=ctx_["scale"]).numpy()
        got = [_emulate_f32_window(ctx_)]
        if s <= 16:
            got.append(_emulate_f32_window(ctx_, block_tiles=1))
        if kind == "decode" and s == 1:
            got.append(_emulate_f32_decode(ctx_))
        for g in got:
            np.testing.assert_allclose(g.numpy(), want, atol=F32_TOL,
                                       rtol=F32_TOL)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_f32_split_merges_chunks_with_no_live_token(kv):
    """Decode chunks and split-window blocks past a row's context hold
    (-inf, 0, 0): merged in, they change nothing and make no NaN, also for
    the dead row."""
    c = _case32(110, 64, "decode", 1)
    kp, vp = _pools32(c, kv)[:2]
    ctx_ = _f32_ctx(c, kp, vp, "decode")
    short = ctx_["n"][:, 0] < ctx_["k"].shape[1] - DEC_CHUNK[kv]
    assert short.any()
    got = _emulate_f32_decode(ctx_, keep_empty=True)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(),
                                  _emulate_f32_decode(ctx_).numpy())
    # a block of one 64-token tile over the long row's last tile: the short
    # rows' states there are empty
    m, den, num = _f32_merge([_f32_warp(ctx_, [(t, t + 16)], 2)
                              for t in range(128, 192, 16)])
    assert bool((m[short] == -np.inf).all()) and bool((den[short] == 0).all())
    assert bool((num[short] == 0).all())


def test_single_tf32_product_fails_the_float32_limit():
    """The control: the 64-row window at D=128 over float pools holds the
    float32 limit with three products and fails it with one (hi hi)."""
    c = _case32(120, 128, "chunked", 20)
    kp, vp = _pools32(c, "float")[:2]
    ctx_ = _f32_ctx(c, kp, vp, "chunked")
    t = _t(c)
    want = cpa.paged_attention_reference(
        t["q"], kp, vp, t["tables"], t["ctx"], t["valid"], t["positions"],
        page_size=PS, kind="chunked", scale=ctx_["scale"]).numpy()
    np.testing.assert_allclose(_emulate_f32_window(ctx_).numpy(), want,
                               atol=F32_TOL, rtol=F32_TOL)
    one = _emulate_f32_window(ctx_, products=1).numpy()
    assert not np.allclose(one, want, atol=F32_TOL, rtol=F32_TOL), \
        "one TF32 product passes the float32 limit"


@pytest.mark.parametrize("nan_bits", [0x7FFFFFFF, 0x7FC00000])
@pytest.mark.parametrize("kind,s", [("decode", 1), ("chunked", 5),
                                    ("chunked", 20)])
def test_f32_nan_key_reaches_the_plain_versions_rows(kind, s, nan_bits):
    """A NaN in one element of one key of row 0 (the card's 0x7fffffff,
    the CPU's quiet NaN), at a token every position of row 0 sees: each
    emulation is NaN in exactly the plain version's entries (row 0 in that
    head) and agrees with it elsewhere at the float32 limit."""
    c = _case32(130 + s, 64, kind, s)
    tok = int(c["ctx"][0]) // 2 if kind == "decode" else \
        int(c["positions"][0, 0]) // 2
    page, off = c["tables"][0, tok // PS], tok % PS
    c["kp"].view(np.int32)[page, off, 1, 5] = nan_bits
    kp, vp = _pools32(c, "float")[:2]
    ctx_ = _f32_ctx(c, kp, vp, kind)
    t = _t(c)
    want = cpa.paged_attention_reference(
        t["q"], kp, vp, t["tables"], t["ctx"], t["valid"], t["positions"],
        page_size=PS, kind=kind, scale=ctx_["scale"])
    nan = want.isnan()
    assert bool(nan[0, :, 1].all()) and not bool(nan[1:].any())
    got = [_emulate_f32_window(ctx_)]
    if kind == "decode":
        got.append(_emulate_f32_decode(ctx_))
    for g in got:
        assert torch.equal(g.isnan(), nan)
        torch.testing.assert_close(g[~nan], want[~nan], atol=F32_TOL,
                                   rtol=F32_TOL)
