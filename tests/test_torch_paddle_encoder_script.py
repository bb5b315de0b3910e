"""One Paddle-style text classifier on ``nn.TransformerEncoder``, run under
``paddle_tpu`` and under ``paddle_tpu_torch``.

The script (``build_model``, ``make_optimizer``, ``loss_of``,
``take_step``, ``train_script``) takes the framework module as its argument
and uses nothing but ``paddle.*``: token and position ``Embedding`` s and a
``LayerNorm``, ``nn.TransformerEncoder(nn.TransformerEncoderLayer(hidden,
heads, 4 · hidden, dropout, activation="gelu", attn_dropout=0.0),
layers)``, a pooler on the first token, a ``Linear(hidden, 2)`` classifier
whose weight carries ``ParamAttr(regularizer=L2Decay(1e-4))``,
``nn.CrossEntropyLoss(label_smoothing=0.1)``, ``AdamW`` with
``ClipGradByGlobalNorm``, and optionally ``amp.decorate`` +
``amp.auto_cast(level="O2")``. ``attn_dropout=0.0`` keeps the training
attention on the flash path (without a mask and without dropout); an
evaluation forward with a bool padding mask ``[B, 1, 1, S]`` takes the
dense path. This module imports neither ``jax`` nor ``paddle_tpu`` at
module level: ``chip_smoke.py`` loads it by path and runs the script on the
card at BERT-base's widths (hidden 768, 12 heads of 64, FFN 3072, vocab
30528, 512 positions, 12 layers) through the port alone.

The tests hold the port against the JAX package at a small size (2 layers,
hidden 64, 4 heads, vocab 128, S=32, B=2, dropout 0), weights carried
across by state dict: three steps in float32 within 1e-5 relative on the
losses and ``tests/test_torch_train.py``'s ``_assert_matches`` on the
parameters; the masked evaluation forward. bf16 O2 is
``test_torch_paddle_encoder_script_bf16.py`` and the ``paddle.save`` files
read across are ``test_torch_paddle_encoder_script_io.py`` (files of their
own, so that the test runner spreads them).
"""
from __future__ import annotations

import os

import numpy as np

SMALL = {"vocab": 128, "hidden": 64, "heads": 4, "layers": 2, "max_pos": 64,
         "seq": 32, "batch": 2, "classes": 2, "dropout": 0.0, "lr": 1e-4}


def build_model(paddle, cfg):
    """The classifier, as a user writes it in Paddle."""
    nn = paddle.nn

    class Classifier(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.word_embeddings = nn.Embedding(c["vocab"], c["hidden"])
            self.position_embeddings = nn.Embedding(c["max_pos"],
                                                    c["hidden"])
            self.embedding_norm = nn.LayerNorm(c["hidden"])
            self.embedding_dropout = nn.Dropout(c["dropout"])
            layer = nn.TransformerEncoderLayer(
                c["hidden"], c["heads"], 4 * c["hidden"],
                dropout=c["dropout"], activation="gelu", attn_dropout=0.0)
            self.encoder = nn.TransformerEncoder(layer, c["layers"])
            self.pooler = nn.Linear(c["hidden"], c["hidden"])
            self.pooler_act = nn.Tanh()
            self.classifier = nn.Linear(
                c["hidden"], c["classes"],
                weight_attr=paddle.ParamAttr(
                    regularizer=paddle.regularizer.L2Decay(1e-4)))

        def forward(self, ids, mask=None):
            pos = paddle.arange(ids.shape[1]).unsqueeze(0)
            h = self.word_embeddings(ids) + self.position_embeddings(pos)
            h = self.embedding_dropout(self.embedding_norm(h))
            h = self.encoder(h, mask)
            return self.classifier(self.pooler_act(self.pooler(h[:, 0])))

    return Classifier(cfg)


def make_optimizer(paddle, cfg, model):
    return paddle.optimizer.AdamW(
        learning_rate=cfg["lr"], parameters=model.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def padding_mask(paddle, lengths, seq):
    """The bool attention mask ``[B, 1, 1, S]`` of rows padded after
    ``lengths``: True where a key is a real token."""
    keep = np.arange(seq)[None, :] < np.asarray(lengths)[:, None]
    return paddle.to_tensor(keep[:, None, None, :])


def loss_of(paddle, model, batch, amp=None):
    """The smoothed cross entropy of one ``(ids [B, S], labels [B])``
    batch."""
    ids, labels = batch
    crit = paddle.nn.CrossEntropyLoss(label_smoothing=0.1)
    with paddle.amp.auto_cast(enable=amp is not None, level="O2",
                              dtype=amp or "bfloat16"):
        return crit(model(paddle.to_tensor(ids)), paddle.to_tensor(labels))


def take_step(paddle, model, opt, batch, amp=None, on_grads=None):
    """``loss.backward(); opt.step(); opt.clear_grad()``; ``on_grads(model)``
    sees the gradients before the step. Returns the loss."""
    loss = loss_of(paddle, model, batch, amp)
    loss.backward()
    if on_grads is not None:
        on_grads(model)
    opt.step()
    opt.clear_grad()
    return float(loss)


def eval_logits(paddle, model, batch, lengths, amp=None):
    """The logits of an evaluation forward (no gradient) under a bool
    padding mask."""
    model.eval()
    try:
        with paddle.no_grad(), paddle.amp.auto_cast(
                enable=amp is not None, level="O2", dtype=amp or "bfloat16"):
            ids = paddle.to_tensor(batch[0])
            return model(ids, padding_mask(paddle, lengths, ids.shape[1]))
    finally:
        model.train()


def train_script(paddle, cfg, steps, seed, batches, amp=None, init=None,
                 on_grads=None, save_dir=None):
    """Build the model from ``seed`` (or ``init``, a state dict), decorate
    it for O2 when ``amp`` names a dtype, take ``steps`` AdamW steps over
    ``batches`` (the dropout masks drawn after ``paddle.seed(seed)``) and
    save both state dicts into ``save_dir``. Returns ``(losses, model,
    optimizer)``."""
    paddle.seed(seed)
    model = build_model(paddle, cfg)
    if init is not None:
        model.set_state_dict(init)
    opt = make_optimizer(paddle, cfg, model)
    if amp is not None:
        model = paddle.amp.decorate(models=model, level="O2", dtype=amp)
    paddle.seed(seed)
    losses = [take_step(paddle, model, opt, batches[i % len(batches)], amp,
                         on_grads) for i in range(steps)]
    if save_dir is not None:
        paddle.save(model.state_dict(),
                    os.path.join(save_dir, "model.pdparams"))
        paddle.save(opt.state_dict(), os.path.join(save_dir, "opt.pdopt"))
    return losses, model, opt


def batches_for(cfg, seed, n=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
             .astype(np.int64),
             rng.randint(0, cfg["classes"], (cfg["batch"],)).astype(np.int64))
            for _ in range(n)]


# ------------------------------------------------------------------ tests
def _packages():
    import paddle_tpu
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu, paddle_tpu_torch


def _arrays(model):
    return {n: np.asarray(p.numpy(), np.float32)
            for n, p in model.state_dict().items()}


def _grads_into(store):
    def on_grads(model):
        store.append({n: np.asarray(p.grad.numpy(), np.float32)
                      for n, p in model.named_parameters()})
    return on_grads


K_BIAS = ".self_attn.k_proj.bias"


def assert_params_match(tag, port, ref, init, steps, lr, grads):
    """``_assert_matches`` on every parameter but the key projections'
    biases, whose exact gradient is zero (softmax ignores a shift of a
    row's scores): both packages hand Adam float32 rounding noise there,
    and each moves them by at most lr a step, which is what they are held
    to."""
    from test_torch_train import _assert_matches
    (pl, pp), (rl, rp) = port, ref
    keep = [n for n in rp if not n.endswith(K_BIAS)]
    _assert_matches(tag, (pl, {n: pp[n] for n in keep}),
                    (rl, {n: rp[n] for n in keep}), init=init, steps=steps,
                    lr=lr, grads=grads)
    for n in rp:
        if n.endswith(K_BIAS):
            for got in (pp[n], rp[n]):
                assert np.abs(got - init[n]).max() <= steps * lr * (
                    1 + 1e-3), (tag, n)


def test_script_float32_matches_jax(tmp_path):
    """Three AdamW steps in float32 from the reference's initial weights:
    losses within 1e-5 relative, the parameters by ``_assert_matches``; the
    regularizer reached the classifier's weight in both."""
    jp, tp = _packages()
    batches = batches_for(SMALL, 1)
    init = _arrays(build_model(jp, SMALL))
    jgrads = []
    jl, jm, _ = train_script(jp, SMALL, 3, 0, batches, init=init,
                             on_grads=_grads_into(jgrads))
    pl, pm, _ = train_script(tp, SMALL, 3, 0, batches, init=init,
                             save_dir=str(tmp_path))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert_params_match("encoder script", (pl, _arrays(pm)),
                        (jl, _arrays(jm)), init, 3, SMALL["lr"], jgrads)
    reg = pm.classifier.weight.regularizer
    assert isinstance(reg, tp.L2Decay) and reg.coeff == 1e-4
    assert pm.pooler.weight.regularizer is None


def test_masked_eval_forward_matches_jax():
    """An evaluation forward under a bool padding mask (rows of 32, 20 and
    5 real tokens) from the same weights: logits within 1e-5, the dense
    attention path in every layer, and padding keys that do not matter."""
    from paddle_tpu_torch.nn.functional import attention as attn
    jp, tp = _packages()
    cfg = dict(SMALL, batch=3)
    batch = batches_for(cfg, 5, n=1)[0]
    init = _arrays(build_model(jp, cfg))
    jm, pm = build_model(jp, cfg), build_model(tp, cfg)
    jm.set_state_dict(init)
    pm.set_state_dict(init)
    lengths = [32, 20, 5]
    before = attn.dense_calls
    got = eval_logits(tp, pm, batch, lengths).numpy()
    assert attn.dense_calls - before == cfg["layers"]
    want = eval_logits(jp, jm, batch, lengths).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    noisy = (batch[0].copy(), batch[1])
    noisy[0][1, 20:] = (noisy[0][1, 20:] + 7) % cfg["vocab"]
    np.testing.assert_allclose(eval_logits(tp, pm, noisy, lengths).numpy(),
                               got, rtol=1e-5, atol=1e-6)
