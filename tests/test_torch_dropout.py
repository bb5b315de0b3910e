"""Port parity for dropout: ``nn.functional.dropout``, ``nn.Dropout``, the
reference's dense attention with probability dropout and its routing, and
the GPT model's dropout sites, against ``paddle_tpu`` on the CPU.

The two packages draw their masks from different generators, so parity is
held by feeding both the same masks (numpy, through each package's one
sampling point: ``jax.random.bernoulli`` in the reference, ``keep_mask`` in
the port), and the port's own generator by its statistics: the kept
fraction of n draws lies within 5 sigma (sigma = sqrt(p (1 - p) / n)) of
1 - p. float32 throughout: the dense attention at atol 1e-5 (the same
maths, sums in another order), the GPT logits at ``test_torch_gpt``'s atol
1e-4, a training step at ``test_torch_train``'s rtol 2e-4 / atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import random as random_mod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny)
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.nn.functional import common as pcommon
from paddle_tpu_torch.nn.functional import dropout, sdpa_dense
from paddle_tpu_torch.ops import cuda_attention as ca
from test_torch_gpt import ATOL as LOGIT_ATOL
from test_torch_train import _assert_matches
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-5
P = 0.1
B, S, H, D = 2, 24, 4, 16


def _within_5_sigma(kept, n, p=P):
    sigma = np.sqrt(p * (1 - p) / n)
    return abs(kept / n - (1 - p)) <= 5 * sigma


class MaskFeed:
    """The same masks for both packages: the i-th call of a forward (i
    modulo ``per_forward``) gets ``RandomState(seed + i)``'s mask of the
    asked shape, so a traced step (which may trace its forward more than
    once) and an eager one see the same masks."""

    def __init__(self, per_forward, seed=0, p=P):
        self.per_forward, self.seed, self.p = per_forward, seed, p
        self.calls = 0

    def mask(self, shape):
        i = self.calls % self.per_forward
        self.calls += 1
        rng = np.random.RandomState(self.seed + i)
        return rng.rand(*shape) < (1.0 - self.p)

    def jax_bernoulli(self, key, p, shape):
        assert np.isclose(float(p), 1.0 - self.p)
        return jnp.asarray(self.mask(tuple(shape)))

    def port_keep(self, shape, p, device, generator=None):
        assert p == self.p
        return torch.from_numpy(self.mask(tuple(shape)))


def _feed(monkeypatch, per_forward):
    """Patch both packages' sampling points with one feed each."""
    jf, pf = MaskFeed(per_forward), MaskFeed(per_forward)
    monkeypatch.setattr(jax.random, "bernoulli", jf.jax_bernoulli)
    monkeypatch.setattr(pcommon, "keep_mask", pf.port_keep)
    monkeypatch.setattr(pattn, "keep_mask", pf.port_keep)
    return jf, pf


# ------------------------------------------------------- the dense attention
@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_with_a_mask_matches_sdpa_reference(monkeypatch,
                                                            causal):
    rng = np.random.RandomState(1 + causal)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    keep = rng.rand(B, H, S, S) < 1 - P
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    want = np.asarray(_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), None, P, causal))
    got = sdpa_dense(*(torch.from_numpy(x) for x in (q, k, v)),
                     causal=causal, keep=torch.from_numpy(keep), dropout_p=P)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_dense_attention_with_an_additive_mask_matches_sdpa_reference():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = np.where(rng.rand(B, 1, S, S) < 0.2, -1e9, 0.0).astype(np.float32)
    want = np.asarray(_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask)))
    got = pattn.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_routing_follows_the_reference():
    """No mask and no dropout (p == 0, or outside training) take the flash
    path; dropout in training, or a mask, the dense path, counted in
    dense_calls, not in the kernels' plain_calls."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, 64).astype(np.float32))
               for _ in range(3))
    cases = [(dict(dropout_p=0.0), "flash"),
             (dict(dropout_p=P, training=False), "flash"),
             (dict(dropout_p=P), "dense"),
             (dict(attn_mask=torch.zeros(S, S)), "dense")]
    for kw, route in cases:
        flash, dense = ca.plain_calls, pattn.dense_calls
        pattn.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)
        assert (ca.plain_calls - flash, pattn.dense_calls - dense) == (
            (1, 0) if route == "flash" else (0, 1)), kw


# ------------------------------------------------------------ the functional
def test_kept_fraction_within_5_sigma():
    random_mod.seed(7)
    x = torch.ones(200, 500)
    y = dropout(x, P)
    kept = int((y != 0).sum())
    assert _within_5_sigma(kept, x.numel()), kept / x.numel()
    # upscale_in_train: kept elements are scaled by 1 / (1 - p)
    torch.testing.assert_close(y[y != 0], torch.full((kept,), 1 / (1 - P)))
    # axis: one mask value along the other dimensions
    z = dropout(torch.ones(64, 300), P, axis=1)
    assert bool((z == z[:1]).all())
    assert _within_5_sigma(int((z[0] != 0).sum()), 300)


def test_p_zero_and_eval_mode_are_identities():
    x = torch.from_numpy(np.random.RandomState(8).randn(6, 7).astype(
        np.float32))
    assert dropout(x, 0.0) is x
    assert dropout(x, P, training=False) is x
    torch.testing.assert_close(
        dropout(x, P, training=False, mode="downscale_in_infer"),
        x * (1 - P))
    layer = Dropout(P)
    layer.eval()
    assert layer(x) is x
    with pytest.raises(ValueError, match="mode"):
        dropout(x, P, mode="sometimes")


def test_the_generator_is_explicit_and_deterministic():
    """Masks come from the port's generator: one seed gives one stream,
    another a different one; torch's global stream plays no part; a saved
    state restores the stream."""
    x = torch.ones(1000)
    random_mod.seed(11)
    a = dropout(x, 0.5)
    state = random_mod.get_rng_state()
    b = dropout(x, 0.5)
    torch.rand(16)                   # torch.s own stream moves on
    random_mod.seed(11)
    assert torch.equal(dropout(x, 0.5), a)
    random_mod.set_rng_state(state)
    assert torch.equal(dropout(x, 0.5), b)
    random_mod.seed(12)
    assert not torch.equal(dropout(x, 0.5), a)
    g = random_mod.Generator(11)
    assert torch.equal(dropout(x, 0.5, generator=g), a)


# ------------------------------------------------------------- the GPT model
def _pair(cfg_kw):
    paddle.seed(0)
    jm = JGPT(j_gpt_tiny(use_flash_attention=False, **cfg_kw))
    pm = GPTForCausalLM(gpt_tiny(**cfg_kw), device="cpu")
    convert.load_jax_state(pm, {k: np.asarray(v._data)
                                for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.mark.parametrize("stacked", [False, True])
def test_gpt_tiny_forward_with_the_same_masks_matches_reference(
        monkeypatch, stacked):
    """In training, with both packages fed the same masks, gpt_tiny's
    logits agree: the sites (embeddings; per layer the attention
    probabilities, the attention output and the MLP output) are the
    reference's, in its order. The stacked decoder applies no layer
    dropout, as the reference's: only the embeddings draw a mask."""
    cfg = gpt_tiny(dropout=P)
    per_forward = 1 if stacked else 1 + 3 * cfg.num_layers
    jf, pf = _feed(monkeypatch, per_forward)
    jm, pm = _pair(dict(dropout=P, stacked=stacked))
    jm.train()
    pm.train()
    ids = np.random.RandomState(12).randint(0, 256, (B, S)).astype(np.int64)
    dense = pattn.dense_calls
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = pm(torch.from_numpy(ids)).detach().numpy()
    assert jf.calls == pf.calls == per_forward
    assert pattn.dense_calls - dense == (0 if stacked else cfg.num_layers)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    pm.eval()
    ref = GPTForCausalLM(gpt_tiny(stacked=stacked), device="cpu")
    ref.load_state_dict(pm.state_dict())
    ref.eval()
    torch.testing.assert_close(pm(torch.from_numpy(ids)),
                               ref(torch.from_numpy(ids)), atol=0, rtol=0)


def test_gpt_tiny_train_step_with_the_same_masks_matches_reference(
        monkeypatch):
    """One AdamW step of gpt_tiny(dropout=0.1), both packages fed the same
    masks: the loss and every parameter agree (rtol 2e-4 / atol 2e-5; the
    qkv bias's key slots, whose exact gradient is zero, to Adam's bound, as
    ``test_torch_train``)."""
    cfg = gpt_tiny(dropout=P)
    _feed(monkeypatch, 1 + 3 * cfg.num_layers)
    jm, pm = _pair(dict(dropout=P))
    init = convert.export_jax_state(pm)
    ids = np.random.RandomState(13).randint(0, 256, (B, S)).astype(np.int64)
    jcrit, pcrit = JCriterion(), GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    popt = paddle_tpu_torch_adamw(pm)
    jl = float(JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)(
        paddle.to_tensor(ids), paddle.to_tensor(ids)).numpy())
    pl = float(TrainStep(pm, lambda o, y: pcrit(o, y), popt)(
        torch.from_numpy(ids), torch.from_numpy(ids)))
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    _assert_matches("dropout step", ([pl], convert.export_jax_state(pm)),
                    ([jl], want), init, steps=1, lr=1e-3)


def paddle_tpu_torch_adamw(model):
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-3, parameters=model.named_parameters())


def test_gpt_tiny_dropout_trains_on_the_port_generator():
    """gpt_tiny(dropout=0.1) trains through TrainStep on the port's own
    generator: the loss falls, attention takes the dense path every step,
    two runs from one seed are bit for bit equal and another seed
    differs."""
    ids = torch.from_numpy(np.random.RandomState(14).randint(
        0, 256, (B, S)).astype(np.int64))

    def run(seed):
        random_mod.seed(seed)
        m = GPTForCausalLM(gpt_tiny(dropout=P), device="cpu", seed=0)
        crit = GPTPretrainingCriterion()
        step = TrainStep(m, lambda o, y: crit(o, y), paddle_tpu_torch_adamw(m))
        before = pattn.dense_calls
        losses = [float(step(ids, ids)) for _ in range(4)]
        assert pattn.dense_calls - before == 4 * m.config.num_layers
        return losses, [p.detach().clone() for p in m.parameters()]

    a, b, c = run(3), run(3), run(4)
    assert a[0][-1] < a[0][0]
    assert a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1],
                                                                  b[1]))
    assert a[0] != c[0]
