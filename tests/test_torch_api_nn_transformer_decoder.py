"""The transformer decoder of the port (a post-LN decoder layer and a
pre-LN stack, with a causal and a memory mask; ``Transformer`` end to
end; a cached greedy decode through ``TransformerDecoder.gen_cache``) and
the stacks' copies against the JAX package's, on the same numpy inputs and
weights (``test_torch_api_nn_transformer.py``'s): outputs and the gradients
of the inputs and every parameter, float32 within 1e-5 relative and 1e-5
absolute. The port's cached decode is held against its uncached forward
and against the reference's cached decode."""
import numpy as np
import pytest

from test_torch_api_nn_transformer import (ATOL, B, BOOL, E, KV, NH, Q, S,
                                           _tensor_like)
from torch_nn_parity import (assert_layer_parity, both, carry_state, rand)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


def _dec_layer(P, pre):
    return P.nn.TransformerDecoderLayer(E, NH, 32, dropout=0.0,
                                        normalize_before=pre)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_decoder_layer_and_stack(pre):
    def call(layer, tgt, mem):
        P = __import__(type(layer).__module__.split(".")[0])
        tm = P.nn.Transformer.generate_square_subsequent_mask(S)
        return layer(tgt, mem, tm, _tensor_like(tgt, BOOL[..., :1].repeat(
            S + 3, -1)))
    if not pre:
        assert_layer_parity(lambda P: _dec_layer(P, pre), [Q, KV],
                            grad=(0, 1), call=call, atol=ATOL)
        return
    assert_layer_parity(lambda P: P.nn.TransformerDecoder(
        _dec_layer(P, pre), 2, P.nn.LayerNorm(E)), [Q, KV], grad=(0, 1),
        call=call, atol=ATOL)


def test_transformer_end_to_end():
    def make(P):
        return P.nn.Transformer(E, NH, 1, 2, 32, dropout=0.0,
                                normalize_before=True)

    def call(model, src, tgt):
        P = __import__(type(model).__module__.split(".")[0])
        return model(src, tgt, None,
                     P.nn.Transformer.generate_square_subsequent_mask(S))
    jl, tl = assert_layer_parity(make, [KV, Q], grad=(0, 1), call=call,
                                 atol=ATOL)
    names = [n for n, _ in tl.named_parameters()]
    assert "encoder.layers.0.self_attn.q_proj.weight" in names
    assert "decoder.layers.1.cross_attn.out_proj.bias" in names
    assert "encoder.layers.1.linear1.weight" not in names
    jp, tp = both()
    np.testing.assert_array_equal(
        tp.nn.Transformer.generate_square_subsequent_mask(5).numpy(),
        jp.nn.Transformer.generate_square_subsequent_mask(5).numpy())


def _greedy(P, model, src, steps, uncached):
    """Greedy decoding of ``steps`` positions: the cached path (one query
    row a step through ``gen_cache``) and, with ``uncached``, the forward of
    the whole prefix; both outputs at every step."""
    emb = P.to_tensor(rand(7, E, seed=9))
    memory = model.encoder(P.to_tensor(src))
    cache = model.decoder.gen_cache(memory)
    tok = np.zeros((B, 1), np.int64)
    toks, cached, full = [tok], [], []
    for t in range(steps):
        step_in = P.nn.functional.embedding(P.to_tensor(toks[-1]), emb)
        out, cache = model.decoder(step_in, memory, cache=cache)
        cached.append(out.numpy()[:, 0])
        if uncached:
            prefix = P.nn.functional.embedding(
                P.to_tensor(np.concatenate(toks, 1)), emb)
            mask = P.nn.Transformer.generate_square_subsequent_mask(t + 1)
            full.append(model.decoder(prefix, memory, mask).numpy()[:, -1])
        logits = out.numpy()[:, 0] @ rand(E, 7, seed=10)
        toks.append(logits.argmax(-1)[:, None].astype(np.int64))
    return np.concatenate(toks, 1), np.stack(cached), \
        np.stack(full) if uncached else None


def test_cached_greedy_decode():
    jp, tp = both()
    models = {P: P.nn.Transformer(E, NH, 1, 2, 32, dropout=0.0)
              for P in (jp, tp)}
    carry_state(models[jp], models[tp])
    res = {}
    for P, m in models.items():
        m.eval()
        toks, cached, full = _greedy(P, m, KV, 3, uncached=P is tp)
        if P is tp:
            np.testing.assert_allclose(cached, full, rtol=1e-5, atol=ATOL)
        res[P] = (toks, cached)
    np.testing.assert_array_equal(res[tp][0], res[jp][0])
    np.testing.assert_allclose(res[tp][1], res[jp][1], rtol=1e-5, atol=ATOL)


def test_copies_keep_param_attrs_and_routing():
    """The stack's copies keep each parameter's ``ParamAttr`` settings; a
    training layer built with the defaults (attention dropout = dropout =
    0.1) takes the dense path, with ``attn_dropout=0.0`` the flash path."""
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import cuda_attention as ca
    _, tp = both()
    reg = tp.regularizer.L2Decay(0.5)
    enc = tp.nn.TransformerEncoder(tp.nn.TransformerEncoderLayer(
        E, NH, 32, weight_attr=tp.ParamAttr(regularizer=reg,
                                            learning_rate=0.3)), 3)
    w = enc.layers[2].linear1.weight
    assert w.regularizer is reg and w.optimize_attr["learning_rate"] == 0.3
    x = tp.to_tensor(Q)
    d0, p0 = attn.dense_calls, ca.plain_calls
    enc(x)
    assert attn.dense_calls - d0 == 3 and ca.plain_calls == p0
    fast = tp.nn.TransformerEncoder(tp.nn.TransformerEncoderLayer(
        E, NH, 32, dropout=0.1, attn_dropout=0.0), 3)
    d0 = attn.dense_calls
    fast(x)
    assert attn.dense_calls == d0 and ca.plain_calls == p0 + 3
