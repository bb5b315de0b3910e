"""The transformer encoder of the port (``MultiHeadAttention`` with and
without masks, both caches and ``need_weights``; the encoder layers and
stacks, pre-LN and post-LN, with their cache) against the JAX package's,
on the same numpy inputs and weights (carried by state dict under the
reference's names): outputs and the gradients of the inputs and every
parameter, float32 within 1e-5 relative and 1e-5 absolute.
``test_torch_api_nn_transformer_decoder.py`` holds the decoder side."""
import numpy as np
import pytest

from torch_nn_parity import (assert_layer_parity, both, carry_state, rand)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

ATOL = 1e-5
B, S, E, NH = 2, 6, 16, 4
Q = rand(B, S, E, seed=1)
KV = rand(B, S + 3, E, seed=2)
BOOL = np.ones((B, 1, 1, S), bool)
BOOL[1, ..., 4:] = False
FLOAT = rand(B, NH, S, S, seed=3, lo=-2, hi=0)


def _call_mha(mask=None, kv=False, need=False):
    def call(layer, q, *rest):
        k = rest[0] if kv else None
        m = None if mask is None else _tensor_like(q, mask)
        return layer(q, k, k, m)
    return call


def _tensor_like(t, arr):
    import paddle_tpu
    import paddle_tpu_torch
    P = paddle_tpu_torch if isinstance(t, paddle_tpu_torch.Tensor) \
        else paddle_tpu
    return P.to_tensor(arr)


MHA = [
    ("self", {}, None, False), ("bool_mask", {}, BOOL, False),
    ("float_mask", {}, FLOAT, False), ("cross_kdim", {"kdim": E,
                                                      "vdim": E}, None, True),
    ("need_weights", {"need_weights": True}, None, False),
]


@pytest.mark.parametrize("kw,mask,kv", [c[1:] for c in MHA],
                         ids=[c[0] for c in MHA])
def test_multi_head_attention(kw, mask, kv):
    arrays = [Q] + ([KV] if kv else [])
    jl, tl = assert_layer_parity(
        lambda P: P.nn.MultiHeadAttention(E, NH, **kw), arrays,
        grad=tuple(range(len(arrays))), call=_call_mha(mask, kv),
        atol=ATOL)
    if kw.get("need_weights"):
        import paddle_tpu_torch as tp
        out = tl(tp.to_tensor(Q))
        assert isinstance(out, tuple) and out[1] is None


def test_mha_caches_step_by_step():
    """``Cache``: each step's query against every key so far equals the
    full forward under a causal mask, in both packages; ``StaticCache``
    holds the projected memory of a cross-attention."""
    jp, tp = both()
    layers = {P: P.nn.MultiHeadAttention(E, NH) for P in (jp, tp)}
    carry_state(layers[jp], layers[tp])
    causal = np.triu(np.full((S, S), -1e9, np.float32), 1)
    res = {}
    for P, mha in layers.items():
        mha.eval()
        x = P.to_tensor(Q)
        full = mha(x, attn_mask=P.to_tensor(causal)).numpy()
        cache = mha.gen_cache(x)
        steps = []
        for t in range(S):
            out, cache = mha(x[:, t:t + 1], cache=cache)
            steps.append(out.numpy())
        assert cache.k.shape == [B, S, NH, E // NH]
        np.testing.assert_allclose(np.concatenate(steps, 1), full,
                                   rtol=1e-5, atol=ATOL)
        mem = P.to_tensor(KV)
        static = mha.gen_cache(mem, mem, type(mha).StaticCache)
        cross = mha(x, mem, mem).numpy()
        np.testing.assert_allclose(mha(x, cache=static).numpy(), cross,
                                   rtol=1e-5, atol=ATOL)
        res[P] = (full, cross)
    for a, b in zip(res[tp], res[jp]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=ATOL)


def _enc_layer(P, pre, act="relu", dropout=0.0):
    return P.nn.TransformerEncoderLayer(E, NH, 32, dropout=dropout,
                                        activation=act,
                                        normalize_before=pre)


@pytest.mark.parametrize("pre,act,mask", [(False, "relu", None),
                                          (True, "gelu", BOOL),
                                          (False, "gelu", FLOAT)],
                         ids=["post_ln", "pre_ln_bool", "post_ln_float"])
def test_encoder_layer_and_stack(pre, act, mask):
    def call(layer, x):
        return layer(x, None if mask is None else _tensor_like(x, mask))
    assert_layer_parity(lambda P: _enc_layer(P, pre, act), [Q], call=call,
                        atol=ATOL)
    assert_layer_parity(lambda P: P.nn.TransformerEncoder(
        _enc_layer(P, pre, act), 2, P.nn.LayerNorm(E) if pre else None),
        [Q], call=call, atol=ATOL)


def test_encoder_eval_drops_nothing():
    """With dropout 0.1 the encoder in eval equals the reference's."""
    assert_layer_parity(lambda P: P.nn.TransformerEncoder(
        _enc_layer(P, False, dropout=0.1), 2), [Q], atol=ATOL, train=False)


def test_encoder_cache():
    jp, tp = both()
    encs = {P: P.nn.TransformerEncoder(_enc_layer(P, True), 2)
            for P in (jp, tp)}
    carry_state(encs[jp], encs[tp])
    res = {}
    for P, enc in encs.items():
        x = P.to_tensor(Q)
        out, caches = enc(x, None, enc.gen_cache(x))
        assert len(caches) == 2 and caches[0].k.shape[1] == S
        res[P] = out.numpy()
    np.testing.assert_allclose(res[tp], res[jp], rtol=1e-5, atol=ATOL)
