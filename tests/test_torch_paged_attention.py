"""Port parity: paged KV-cache plumbing and the paged-attention kernel's plain
version (paddle_tpu_torch/ops/{paged_attention,cuda_paged_attention}.py)
against the JAX package (ops/paged_attention.py and the Pallas kernel
ops/pallas_paged_attention.py in interpret mode).

Inputs are made from seeded numpy and handed to both packages, in float32.
Live rows are compared at atol 1e-5 (float32 sums in another order); dead
rows of the port are exactly zero (the JAX pure path leaves an average of
garbage there, so they are not compared with it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import pallas_paged_attention as jppa
from paddle_tpu_torch.ops import cuda_paged_attention as cpa
from paddle_tpu_torch.ops import paged_attention as tpa

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


def test_int8_pools_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="int8"):
        tpa.resolve_kv_dtype("int8")
    pool = (torch.zeros(2, PS, H, D, dtype=torch.int8),
            torch.zeros(2, PS, H))
    with pytest.raises(NotImplementedError, match="int8"):
        tpa.write_pool(pool, torch.zeros(1, dtype=torch.long),
                       torch.zeros(1, H, D))
