"""One Paddle-style GPT training script, run under ``paddle_tpu`` and under
``paddle_tpu_torch``.

The script (``build_model``, ``make_optimizer``, ``take_step``,
``train_script``) takes the framework module as its argument and uses
nothing but ``paddle.*``: a GPT decoder written against Paddle's API
(``nn.Layer``, token and position ``Embedding``, a ``LayerList`` of pre-LN
blocks with ``F.scaled_dot_product_attention(..., is_causal=True)`` in
``[B, S, H, D]``, a ``GELU`` MLP, a final ``LayerNorm`` and an LM head tied
to the token embedding through ``paddle.matmul(..., transpose_y=True)``),
``F.cross_entropy``, ``AdamW`` with ``ClipGradByGlobalNorm``,
``loss.backward(); opt.step(); opt.clear_grad()``, optionally under
``amp.auto_cast(level="O2")`` with ``amp.decorate``, and ``paddle.save`` of
both state dicts. This module imports neither ``jax`` nor ``paddle_tpu`` at
module level: ``chip_smoke.py`` loads it by path and runs the script on the
card (GPT-2 small at full width) through the port alone.

The tests hold the port against the JAX package at a small size (2 layers,
hidden 64, 4 heads, vocab 128, S=32, B=2), weights carried across by state
dict: float32 losses within 1e-5 relative over three AdamW steps and the
parameters by ``tests/test_torch_train.py``'s ``_assert_matches``, each
package reading the other's ``paddle.save`` files, and a resume from them;
bf16 O2 within 1.5x the JAX bf16 run's distance from the JAX float32 run is
``test_torch_paddle_script_bf16.py`` (a file of its own, so that the test
runner spreads the two packages' first-call compiles).
"""
from __future__ import annotations

import os

import numpy as np

SMALL = {"vocab": 128, "hidden": 64, "heads": 4, "layers": 2, "max_pos": 64,
         "seq": 32, "batch": 2, "lr": 1e-4}


def build_model(paddle, cfg):
    """The GPT decoder of the script, as a user writes it in Paddle."""
    nn = paddle.nn
    F = paddle.nn.functional

    class Attention(nn.Layer):
        def __init__(self, hidden, heads):
            super().__init__()
            self.heads = heads
            self.qkv_proj = nn.Linear(hidden, 3 * hidden)
            self.out_proj = nn.Linear(hidden, hidden)

        def forward(self, x):
            b, s, h = x.shape
            qkv = self.qkv_proj(x).reshape([b, s, self.heads, 3,
                                            h // self.heads])
            q, k, v = paddle.unbind(qkv, axis=3)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.out_proj(out.reshape([b, s, h]))

    class Block(nn.Layer):
        def __init__(self, hidden, heads):
            super().__init__()
            self.ln_1 = nn.LayerNorm(hidden)
            self.attn = Attention(hidden, heads)
            self.ln_2 = nn.LayerNorm(hidden)
            self.fc_in = nn.Linear(hidden, 4 * hidden)
            self.act = nn.GELU()
            self.fc_out = nn.Linear(4 * hidden, hidden)

        def forward(self, x):
            x = x + self.attn(self.ln_1(x))
            return x + self.fc_out(self.act(self.fc_in(self.ln_2(x))))

    class GPT(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.wte = nn.Embedding(c["vocab"], c["hidden"])
            self.wpe = nn.Embedding(c["max_pos"], c["hidden"])
            self.blocks = nn.LayerList([Block(c["hidden"], c["heads"])
                                        for _ in range(c["layers"])])
            self.ln_f = nn.LayerNorm(c["hidden"])

        def forward(self, ids):
            pos = paddle.arange(ids.shape[1]).unsqueeze(0)
            h = self.wte(ids) + self.wpe(pos)
            for block in self.blocks:
                h = block(h)
            h = self.ln_f(h)
            return paddle.matmul(h, self.wte.weight, transpose_y=True)

    return GPT(cfg)


def make_optimizer(paddle, cfg, model):
    return paddle.optimizer.AdamW(
        learning_rate=cfg["lr"], parameters=model.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def loss_of(paddle, model, batch, amp=None):
    """The loss of one ``[B, S + 1]`` token batch (next-token targets)."""
    F = paddle.nn.functional
    x = paddle.to_tensor(batch[:, :-1])
    y = paddle.to_tensor(batch[:, 1:])
    with paddle.amp.auto_cast(enable=amp is not None, level="O2",
                              dtype=amp or "bfloat16"):
        logits = model(x)
        return F.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                               y.reshape([-1]))


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


def train_script(paddle, cfg, steps, seed, batches, amp=None, init=None,
                 on_grads=None, save_dir=None):
    """Build the model from ``seed`` (or ``init``, a state dict), decorate
    it for O2 when ``amp`` names a dtype, take ``steps`` AdamW steps over
    ``batches`` and save both state dicts into ``save_dir``. Returns
    ``(losses, model, optimizer)``."""
    paddle.seed(seed)
    model = build_model(paddle, cfg)
    if init is not None:
        model.set_state_dict(init)
    opt = make_optimizer(paddle, cfg, model)
    if amp is not None:
        model = paddle.amp.decorate(models=model, level="O2", dtype=amp)
    losses = [take_step(paddle, model, opt, batches[i % len(batches)], amp,
                         on_grads) for i in range(steps)]
    if save_dir is not None:
        paddle.save(model.state_dict(),
                    os.path.join(save_dir, "model.pdparams"))
        paddle.save(opt.state_dict(), os.path.join(save_dir, "opt.pdopt"))
    return losses, model, opt


def rename_optimizer_state(state, old_model, new_model):
    """An optimizer state dict keyed by ``old_model``'s parameter names,
    keyed by ``new_model``'s instead (a fresh model in the same process
    gets fresh parameter names)."""
    names = {p.name: q.name for p, q in zip(old_model.parameters(),
                                            new_model.parameters())}
    out = {}
    for key, value in state.items():
        stem, _, acc = key.rpartition("_")
        while stem and stem not in names:
            stem, _, more = stem.rpartition("_")
            acc = more + "_" + acc
        out[f"{names[stem]}_{acc}" if stem else key] = value
    return out


def batches_for(cfg, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"] + 1))
            .astype(np.int64) for _ in range(n)]


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


def test_script_float32_matches_jax(tmp_path):
    """Three AdamW steps in float32 from the reference's initial weights:
    losses within 1e-5 relative, the parameters by ``_assert_matches``
    (Adam's bound on elements whose gradient is rounding noise)."""
    from test_torch_train import _assert_matches
    jp, tp = _packages()
    batches = batches_for(SMALL, 1)
    jgrads = []
    init_model = build_model(jp, SMALL)
    init = _arrays(init_model)
    jl, jm, _ = train_script(jp, SMALL, 3, 0, batches, init=init,
                             on_grads=_grads_into(jgrads))
    pl, pm, _ = train_script(tp, SMALL, 3, 0, batches, init=init,
                             save_dir=str(tmp_path))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pm.state_dict().keys() == jm.state_dict().keys()
    _assert_matches("script", (pl, _arrays(pm)), (jl, _arrays(jm)),
                    init=init, steps=3, lr=SMALL["lr"], grads=jgrads)
    assert all(isinstance(p, tp.Parameter) for p in pm.parameters())


def test_save_files_read_across_both_ways(tmp_path):
    """Each package's ``paddle.save`` of the model's and the optimizer's
    state dicts loads in the other; the model's loads into the other's
    model and gives its logits."""
    jp, tp = _packages()
    batches = batches_for(SMALL, 3, n=1)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    _, jm, jo = train_script(jp, SMALL, 1, 0, batches, save_dir=str(jdir))
    _, pm, po = train_script(tp, SMALL, 1, 0, batches, save_dir=str(pdir))
    x = batches[0][:, :-1]
    logits = {jp: jm(jp.to_tensor(x)).numpy(), tp: pm(tp.to_tensor(x)).numpy()}
    for src_dir, src, src_model, dst, dst_model, src_opt in (
            (jdir, jp, jm, tp, pm, jo), (pdir, tp, pm, jp, jm, po)):
        sd = dst.load(str(src_dir / "model.pdparams"))
        assert list(sd) == list(src_model.state_dict())
        assert all(isinstance(v, dst.Tensor) for v in sd.values())
        dst_model.set_state_dict(sd)
        np.testing.assert_allclose(dst_model(dst.to_tensor(x)).numpy(),
                                   logits[src], rtol=1e-5, atol=1e-5)
        osd = dst.load(str(src_dir / "opt.pdopt"))
        assert osd.keys() == src_opt.state_dict().keys()
        assert int(osd["@step"]) == 1


def test_resume_from_saved_state_is_exact(tmp_path):
    """Two steps, save, load into a fresh model and optimizer (the
    optimizer state renamed to the fresh parameters), and the third step
    both ways: bit for bit."""
    _, tp = _packages()
    batches = batches_for(SMALL, 4)
    _, pm, po = train_script(tp, SMALL, 2, 0, batches, save_dir=str(tmp_path))
    fresh = build_model(tp, SMALL)
    fresh.set_state_dict(tp.load(str(tmp_path / "model.pdparams")))
    fopt = make_optimizer(tp, SMALL, fresh)
    fopt.set_state_dict(rename_optimizer_state(
        tp.load(str(tmp_path / "opt.pdopt")), pm, fresh))
    a = take_step(tp, pm, po, batches[2])
    b = take_step(tp, fresh, fopt, batches[2])
    assert a == b
    for (n, p), (_, q) in zip(pm.named_parameters(),
                              fresh.named_parameters()):
        assert np.array_equal(p.numpy(), q.numpy()), n
