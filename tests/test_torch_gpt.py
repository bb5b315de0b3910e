"""Port parity: GPT (paddle_tpu_torch/models/gpt.py), the weight bridge
(convert.py) and the cached decoder (serving/generation/model_fns.py)
against the JAX package at ``gpt_tiny`` in float32 on the CPU.

Weights cross through ``load_jax_state`` (the JAX names are the port's
state_dict keys; 2-D Linear weights are transposed). Inputs come from seeded
numpy. Tolerance atol 1e-4 on logits: float32 sums in another order through
two layers and the tied head.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.serving.generation.model_fns import CachedDecoder as JDecoder
from paddle_tpu_torch.convert import load_jax_state, load_paddle_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b, gpt_tiny
from paddle_tpu_torch.serving.generation.model_fns import (
    CachedDecoder, supports_cached_decode)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

ATOL = 1e-4


def make_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def test_state_dict_names_match_the_reference():
    jm, tm = make_pair()
    j = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    t = tm.state_dict()
    assert set(j) == set(t) and len(t) == 28
    for name, shape in j.items():
        want = shape[::-1] if (name.endswith(".weight") and len(shape) == 2
                               and "embeddings" not in name) else shape
        assert tuple(t[name].shape) == want, name
    # embeddings cross untransposed, projections transposed
    np.testing.assert_array_equal(
        tm.gpt.embeddings.position_embeddings.detach().numpy(),
        jm.gpt.embeddings.position_embeddings.numpy())
    np.testing.assert_array_equal(
        tm.gpt.layers[0].attn.qkv_proj.weight.detach().numpy().T,
        jm.gpt.layers[0].attn.qkv_proj.weight.numpy())


@pytest.mark.parametrize("seq", [1, 9, 40])
def test_logits_match_reference(seq):
    jm, tm = make_pair()
    ids = np.random.RandomState(seq).randint(0, 256, (2, seq)).astype(
        np.int64)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_qkv_split_is_head_major_and_gelu_is_tanh():
    _, tm = make_pair()
    attn = tm.gpt.layers[0].attn
    x = torch.randn(1, 3, 64)
    qkv = attn.qkv_proj(x).view(1, 3, attn.num_heads, 3, attn.head_dim)
    w = attn.qkv_proj.weight.view(attn.num_heads, 3, attn.head_dim, 64)
    # head 1's k rows sit at (head 1, slot 1) of the [nh, 3, hd] layout
    torch.testing.assert_close(
        qkv[0, :, 1, 1], x[0] @ w[1, 1].T + attn.qkv_proj.bias.view(
            attn.num_heads, 3, -1)[1, 1])
    mlp = tm.gpt.layers[0].mlp
    u = mlp.fc_in(x)
    tanh_gelu = 0.5 * u * (1 + torch.tanh(
        np.sqrt(2 / np.pi) * (u + 0.044715 * u ** 3)))
    torch.testing.assert_close(mlp(x), mlp.fc_out(tanh_gelu))


def _tables(b, pps):
    return (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cached_prefill_decode_chunked_match_jax(use_pallas):
    jm, tm = make_pair()
    b, window, ps, pps = 2, 8, 4, 8
    rng = np.random.RandomState(3)
    lens = np.array([5, 3], np.int32)
    ids = np.zeros((b, window), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 256, n)
    tables = _tables(b, pps)
    jd = JDecoder(jm, max_batch=b, page_size=ps, pages_per_seq=pps,
                  use_pallas=use_pallas)
    td = CachedDecoder(tm, max_batch=b, page_size=ps, pages_per_seq=pps,
                       device="cpu")
    jk, jv = jm.init_kv_pools(1 + b * pps, ps)
    tk, tv = tm.init_kv_pools(1 + b * pps, ps)
    jl, jk, jv, _ = jd.prefill(ids, lens, tables, jk, jv)
    tl, tk, tv = td.prefill(ids, lens, tables, tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    ctx = lens.copy()
    tok = np.asarray(jl).argmax(-1).astype(np.int64)
    for _ in range(6):
        active = np.array([True, True])
        jl, jk, jv, _ = jd.decode(tok, ctx, active, ctx + 1, tables, jk, jv)
        tl, tk, tv = td.decode(tok, ctx, active, ctx + 1, tables, tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int64)   # teacher-forced
        ctx = ctx + 1
    # a chunked window at each row's next position (row 1 dead)
    win = rng.randint(0, 256, (b, 4)).astype(np.int64)
    seg = np.array([3, 0], np.int32)
    jl, jk, jv, _ = jd.prefill_chunked(win, ctx, seg, tables, jk, jv)
    tl, tk, tv = td.prefill_chunked(win, ctx, seg, tables, tk, tv)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=ATOL,
                               rtol=0)
    # the pools hold the same K/V for every written slot
    used = tables[:, :4].reshape(-1)
    np.testing.assert_allclose(tk[1].numpy()[used], np.asarray(jk[1])[used],
                               atol=ATOL, rtol=0)


def test_paddle_save_roundtrip(tmp_path):
    jm, tm = make_pair()
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(jm.state_dict(), path)
    arrays = load_paddle_state(path)
    assert set(arrays) == set(tm.state_dict())
    fresh = GPTForCausalLM(gpt_tiny(), device="cpu", seed=123)
    load_jax_state(fresh, arrays)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 7)).astype(np.int64))
    with torch.no_grad():
        torch.testing.assert_close(fresh(ids), tm(ids), atol=0, rtol=0)
    with pytest.raises(KeyError):
        load_jax_state(fresh, {k: v for k, v in arrays.items()
                               if "ln_f" not in k})


def test_seeded_init_kv_spec_and_limits():
    a = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    b = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    c = GPTForCausalLM(gpt_tiny(), device="cpu", seed=2)
    wa, wb, wc = (m.gpt.layers[1].mlp.fc_in.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert supports_cached_decode(a)
    spec = a.kv_cache_spec()
    assert spec["num_heads"] == 4 and spec["head_dim"] == 16
    assert spec["kv_bytes_per_token"] == 2 * 2 * 4 * 16 * 4
    k, v = a.init_kv_pools(5, 4)
    assert len(k) == len(v) == 2 and k[0].shape == (5, 4, 4, 16)
    k8, v8 = a.init_kv_pools(5, 4, "int8")
    assert len(k8) == len(v8) == 2
    assert k8[0][0].dtype == torch.int8 and k8[0][0].shape == (5, 4, 4, 16)
    assert k8[0][1].dtype == torch.float32 and k8[0][1].shape == (5, 4, 4)
    assert not any(t.any() for pool in k8 + v8 for t in pool)
    assert a.kv_cache_spec("int8")["kv_bytes_per_token"] == \
        2 * 2 * 4 * (16 + 4)
    # the stacked decoder builds (tests/test_torch_stacked.py holds it
    # against the reference); an unknown recompute policy raises as there
    st = GPTForCausalLM(gpt_tiny(stacked=True), device="cpu")
    assert st.kv_cache_spec()["stacked"] and len(st.gpt.layers) == 0
    assert tuple(st.gpt.decoder.qkv_w.shape) == (2, 64, 192)
    sk, sv = st.init_kv_pools(5, 4)
    assert sk.shape == sv.shape == (2, 5, 4, 4, 16)
    with pytest.raises(ValueError, match="recompute must be"):
        gpt_tiny(stacked=True, recompute="sometimes")
    big = gpt3_1p3b()
    assert (big.hidden_size, big.num_layers, big.num_heads,
            big.hidden_size // big.num_heads, big.vocab_size,
            big.max_seq_len) == (2048, 24, 16, 128, 50304, 2048)
