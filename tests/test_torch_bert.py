"""Port parity for BERT (``models/bert.py``) and ``recompute``
(``distributed/fleet/utils.py``) against ``paddle_tpu`` on the CPU, on
``bert_tiny``.

Weights come from the JAX model through ``convert.py``; inputs from seeded
numpy. On the CPU both packages' attention is the dense maths (the port's
plain versions of the flash kernels without a mask, ``sdpa_dense`` with
one). float32: MLM and NSP logits atol 1e-4 (``test_torch_gpt``'s), with
and without an additive padding mask; AdamW steps at ``test_torch_train``'s
rtol 2e-4 / atol 2e-5 (the qkv bias's key slots, whose exact gradient is
zero, to Adam's bound). Dropout is held with the same keep masks fed to
both packages (``test_torch_dropout``'s feed on the reference's side); on
the port's side each mask is keyed by a number drawn from the port's
generator, so a recompute that did not replay the generator's state would
draw other keys, get other masks and miss the reference's gradients. O2 is
held by the rounding-floor rule (``test_torch_train.O2_FACTOR``).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import BertForPretraining as JBertPretrain
from paddle_tpu.models import BertForSequenceClassification as JBertCls
from paddle_tpu.models import BertPretrainingCriterion as JCriterion
from paddle_tpu.models import bert_tiny as j_bert_tiny
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.framework import random as random_mod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertForSequenceClassification,
                                     BertPretrainingCriterion, bert_tiny)
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.nn.functional import common as pcommon
from paddle_tpu_torch.nn.functional import dropout
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.optimizer import AdamW
from test_torch_dropout import MaskFeed
from test_torch_gpt import ATOL as LOGIT_ATOL
from test_torch_train import O2_FACTOR, _assert_matches, _l2
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

B, S = 2, 32
P = 0.1
LR = 1e-4          # test_torch_train's rate


def _jax_model(kind="pretrain", **kw):
    paddle.seed(0)
    cfg = j_bert_tiny(use_flash_attention=False, **kw)
    return JBertPretrain(cfg) if kind == "pretrain" else JBertCls(cfg)


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _port_model(arrays, kind="pretrain", **kw):
    cls = BertForPretraining if kind == "pretrain" \
        else BertForSequenceClassification
    return convert.load_jax_state(cls(bert_tiny(**kw), device="cpu"), arrays)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (B, S)).astype(np.int64)
    tt = rng.randint(0, 2, (B, S)).astype(np.int64)
    labels = ids.copy()
    labels[rng.rand(B, S) < 0.5] = -100     # unmasked tokens are ignored
    nsp = rng.randint(0, 2, (B,)).astype(np.int64)
    return ids, tt, labels, nsp


def _padding_mask(lengths=(S, 20)):
    """The additive mask users hand BERT: 0 on real tokens, -1e4 on the
    padding, ``[B, 1, 1, S]``."""
    m = np.zeros((B, 1, 1, S), np.float32)
    for i, n in enumerate(lengths):
        m[i, ..., n:] = -1e4
    return m


def test_state_dict_names_match_the_reference():
    jm = _jax_model()
    pm = BertForPretraining(bert_tiny(), device="cpu")
    assert set(pm.state_dict()) == set(_arrays(jm))


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "padded"])
def test_pretraining_logits_match_reference(masked):
    jm = _jax_model()
    pm = _port_model(_arrays(jm))
    ids, tt, _, _ = _batch(1)
    mask = _padding_mask() if masked else None
    dense, plain = pattn.dense_calls, ca.plain_calls
    jmlm, jnsp = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                    None if mask is None else paddle.to_tensor(mask))
    mlm, nsp = pm(torch.from_numpy(ids), torch.from_numpy(tt),
                  None if mask is None else torch.from_numpy(mask))
    assert mlm.shape == (B, S, 256) and nsp.shape == (B, 2)
    # the reference's routing: a mask takes the dense path, none the flash
    # path (its plain version on the CPU)
    layers = bert_tiny().num_layers
    assert pattn.dense_calls - dense == (layers if masked else 0)
    assert ca.plain_calls - plain == (0 if masked else layers)
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(jmlm._data),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(jnsp._data),
                               atol=LOGIT_ATOL, rtol=0)


def _jax_train(jm, steps, batch, amp_level=None, n_inputs=1):
    crit = JCriterion()
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    step = JTrainStep(jm, lambda out, y, nsp: crit(out, y, nsp), opt,
                      amp_level=amp_level)
    t = [paddle.to_tensor(a) for a in batch]
    losses = [float(step(*t, n_inputs=n_inputs).numpy())
              for _ in range(steps)]
    return losses, _arrays(jm)


def _port_train(pm, steps, batch, amp_level=None, n_inputs=1):
    crit = BertPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=pm.named_parameters())
    step = TrainStep(pm, lambda out, y, nsp: crit(out, y, nsp), opt,
                     amp_level=amp_level)
    t = [torch.from_numpy(a) for a in batch]
    losses = [float(step(*t, n_inputs=n_inputs)) for _ in range(steps)]
    return losses, convert.export_jax_state(pm)


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "padded"])
def test_two_adamw_steps_match_reference(masked):
    """The three-item batch (ids, MLM labels, NSP labels) with
    ``n_inputs=1``, as bench.py feeds it; padded: the model's inputs are
    ids, token types and the additive mask (``n_inputs=3``)."""
    jm = _jax_model()
    init = _arrays(jm)
    pm = _port_model(init)
    ids, tt, labels, nsp = _batch(2)
    if masked:
        batch, n = (ids, tt, _padding_mask(), labels, nsp), 3
    else:
        batch, n = (ids, labels, nsp), 1
    ref = _jax_train(jm, 2, batch, n_inputs=n)
    port = _port_train(pm, 2, batch, n_inputs=n)
    _assert_matches("bert AdamW", port, ref, init, steps=2, lr=LR)
    assert port[0][1] < port[0][0]


def test_sequence_classification_matches_reference():
    jm = _jax_model("cls")
    pm = _port_model(_arrays(jm), "cls")
    ids, tt, _, _ = _batch(3)
    mask = _padding_mask((S, 9))
    want = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
              paddle.to_tensor(mask))
    got = pm(torch.from_numpy(ids), torch.from_numpy(tt),
             torch.from_numpy(mask))
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               atol=LOGIT_ATOL, rtol=0)


class GeneratorKeyedFeed(MaskFeed):
    """The port's side of the mask feed: each draw takes one number from
    the port's generator and gets the mask of that number's order of first
    appearance (modulo ``per_forward``), so replaying the generator's state
    replays the masks."""

    def __init__(self, per_forward, seed=0, p=P):
        super().__init__(per_forward, seed, p)
        self.order = {}

    def port_keep(self, shape, p, device, generator=None):
        assert p == self.p
        gen = (generator or random_mod.default_generator()).for_device(
            device)
        key = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        i = self.order.setdefault(key, len(self.order)) % self.per_forward
        self.calls += 1
        rng = np.random.RandomState(self.seed + i)
        return torch.from_numpy(rng.rand(*shape) < (1.0 - self.p))


@pytest.mark.parametrize("use_recompute", [False, True],
                         ids=["stored", "recompute"])
@pytest.mark.parametrize("p", [0.0, P], ids=["no_dropout", "dropout"])
def test_recompute_and_dropout_match_reference(monkeypatch, use_recompute,
                                               p):
    """Two AdamW steps under each of ``recompute`` x dropout, the same
    masks in both packages (per forward: the embeddings, then per layer the
    attention probabilities, the attention output and the MLP output)."""
    kw = dict(recompute=use_recompute, hidden_dropout_prob=p,
              attention_probs_dropout_prob=p)
    per_forward = 1 + 3 * bert_tiny().num_layers
    jf, pf = MaskFeed(per_forward), GeneratorKeyedFeed(per_forward)
    monkeypatch.setattr(jax.random, "bernoulli", jf.jax_bernoulli)
    monkeypatch.setattr(pcommon, "keep_mask", pf.port_keep)
    monkeypatch.setattr(pattn, "keep_mask", pf.port_keep)
    random_mod.seed(1)
    jm = _jax_model(**kw)
    init = _arrays(jm)
    pm = _port_model(init, **kw)
    ids, _, labels, nsp = _batch(4)
    ref = _jax_train(jm, 2, (ids, labels, nsp))
    port = _port_train(pm, 2, (ids, labels, nsp))
    _assert_matches(f"bert recompute={use_recompute} p={p}", port, ref,
                    init, steps=2, lr=LR)
    # the forward's draws, and with recompute their replay in the backward
    layer_draws = 3 * bert_tiny().num_layers if use_recompute else 0
    assert pf.calls == (2 * (per_forward + layer_draws) if p else 0)
    assert len(pf.order) == (2 * per_forward if p else 0)


def test_recompute_replays_the_port_generator():
    """``recompute`` of a segment that draws dropout masks from the port's
    generator: the gradient equals the stored segment's, and the generator
    ends where the stored run leaves it."""
    x = torch.from_numpy(np.random.RandomState(6).randn(4, 8).astype(
        np.float32))
    w = torch.from_numpy(np.random.RandomState(7).randn(8, 8).astype(
        np.float32))

    def segment(h, w):
        return dropout(torch.tanh(h @ w), P, training=True) @ w

    out = {}
    for use in (False, True):
        random_mod.seed(3)
        h, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = recompute(segment, h, ww) if use else segment(h, ww)
        y.square().sum().backward()
        after = random_mod.default_generator().for_device("cpu").get_state()
        out[use] = (y.detach(), h.grad, ww.grad, after)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_amp_o2_within_the_rounding_floor():
    """Two O2 steps: the port's distance from the float32 run at most
    O2_FACTOR x the reference O2's own, on the losses and the parameters
    (L2 over all of them)."""
    jm32 = _jax_model()
    init = _arrays(jm32)
    batch = _batch(5)
    batch = (batch[0], batch[2], batch[3])
    fl, fp = _jax_train(jm32, 2, batch)
    jl, jp = _jax_train(_jax_model(), 2, batch, amp_level="O2")
    pl, pp = _port_train(_port_model(init), 2, batch, amp_level="O2")
    ref_loss = max(abs(a - b) for a, b in zip(jl, fl))
    port_loss = max(abs(a - b) for a, b in zip(pl, fl))
    ref_par, port_par = _l2(jp, fp), _l2(pp, fp)
    assert 0 < ref_loss and 0 < ref_par
    assert port_loss <= O2_FACTOR * ref_loss, (port_loss, ref_loss)
    assert port_par <= O2_FACTOR * ref_par, (port_par, ref_par)



@pytest.mark.parametrize("cls", ["BertModel", "BertForPretraining",
                                 "BertForSequenceClassification",
                                 "ErnieModel",
                                 "ErnieForSequenceClassification"])
def test_weights_are_drawn_once(monkeypatch, cls):
    """A task model draws every weight once, its encoder's included (the
    encoder inside it is built with ``seed=None``); the weights are those
    of the draw from the task model's seed."""
    import paddle_tpu_torch.models as models
    from paddle_tpu_torch.models import bert as bert_mod
    draws = []
    real = bert_mod.init_encoder_weights
    monkeypatch.setattr(bert_mod, "init_encoder_weights",
                        lambda m, seed, std: (draws.append(type(m).__name__),
                                              real(m, seed, std)))
    model = getattr(models, cls)(bert_tiny(), device="cpu", seed=3)
    assert draws == [cls]
    again = getattr(models, cls)(bert_tiny(), device="cpu", seed=3)
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
