"""``paddle.Model`` (hapi) of the port against the JAX package's: the
encoder classifier of ``test_torch_paddle_encoder_script.py`` (2 layers,
hidden 64, dropout 0) wrapped in ``Model``, prepared with ``Lamb`` over a
linear-warmup schedule (no decay on the one-dimensional parameters),
``CrossEntropyLoss`` and ``Accuracy``, then ``fit`` over seeded batches
with ``eval_data``, the ``LRScheduler``, ``ModelCheckpoint`` and
``EarlyStopping`` callbacks, ``evaluate``, ``predict``, ``save``/``load``
and ``summary``. The slice as a whole on the CPU; bf16 O2 is
``test_torch_api_hapi_bf16.py`` (a file of its own, so that the test
runner spreads them).

The helpers (``samples``, ``make_model``, ``fit_run``, ``Recorder``) take
the framework module as their argument and import neither ``jax`` nor
``paddle_tpu`` at module level: ``chip_smoke.py`` loads this file by path
and runs them on the card at BERT-base's widths through the port alone.
"""
from __future__ import annotations

import os

import numpy as np


def samples(paddle, cfg, n_batches, seed):
    """An ``io.Dataset`` of ``n_batches · batch`` ``(ids [S], label)``
    samples from ``seed``."""
    rng = np.random.RandomState(seed)
    n = n_batches * cfg["batch"]
    ids = rng.randint(0, cfg["vocab"], (n, cfg["seq"])).astype(np.int64)
    labels = rng.randint(0, cfg["classes"], (n,)).astype(np.int64)

    class Samples(paddle.io.Dataset):
        def __getitem__(self, i):
            return ids[i], labels[i]

        def __len__(self):
            return n
    return Samples()


def no_decay(p):
    """LAMB's exclusion: biases and norms (the one-dimensional
    parameters)."""
    return len(p.shape) == 1


def make_model(paddle, script, cfg, init=None, amp=None, warmup=3):
    """``Model(classifier).prepare(Lamb, CrossEntropyLoss, Accuracy)`` from
    ``init`` (a state dict) or the current seed; ``amp`` is
    ``amp_configs``. The learning rate warms up linearly to ``cfg["lr"]``
    over ``warmup`` steps."""
    net = script.build_model(paddle, cfg)
    if init is not None:
        net.set_state_dict(init)
    sched = paddle.optimizer.lr.LinearWarmup(cfg["lr"], warmup, 0.0,
                                             cfg["lr"])
    opt = paddle.optimizer.Lamb(
        learning_rate=sched, lamb_weight_decay=0.01,
        parameters=net.parameters(), exclude_from_weight_decay_fn=no_decay)
    model = paddle.Model(net)
    model.prepare(optimizer=opt, loss=paddle.nn.CrossEntropyLoss(),
                  metrics=paddle.metric.Accuracy(), amp_configs=amp)
    return model


def recorder(paddle):
    """A callback that records every hook it sees, with its step or epoch
    and its logs."""
    class Recorder(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.events = []

        def _log(self, name, *args):
            self.events.append((name,) + tuple(args))

    for hook in ("train_begin", "train_end", "eval_begin", "eval_end"):
        setattr(Recorder, f"on_{hook}", lambda self, logs=None, _h=hook:
                self._log(_h, dict(logs or {})))
    for hook in ("epoch_begin", "epoch_end", "train_batch_begin",
                 "train_batch_end", "eval_batch_begin", "eval_batch_end"):
        setattr(Recorder, f"on_{hook}", lambda self, i, logs=None, _h=hook:
                self._log(_h, i, dict(logs or {})))
    return Recorder()


def fit_run(paddle, model, train, evald, batch, save_dir, epochs=1,
            patience=0, min_delta=0.0, extra=()):
    """``model.fit`` with the LRScheduler (a step a batch),
    ModelCheckpoint (into ``save_dir``) and EarlyStopping (on the
    evaluation's loss) callbacks, a recorder and the ``extra`` callbacks;
    returns ``(history, recorder events, early stopping)``."""
    rec = recorder(paddle)
    early = paddle.callbacks.EarlyStopping(
        monitor="loss", mode="min", patience=patience, min_delta=min_delta,
        verbose=0)
    cbs = [paddle.callbacks.LRScheduler(by_step=True, by_epoch=False),
           paddle.callbacks.ModelCheckpoint(save_dir=save_dir), early, rec,
           *extra]
    history = model.fit(train, evald, batch_size=batch, epochs=epochs,
                        shuffle=False, verbose=0, callbacks=cbs)
    return history, rec.events, early


# ------------------------------------------------------------------ tests
CFG = {"vocab": 128, "hidden": 64, "heads": 4, "layers": 2, "max_pos": 64,
       "seq": 16, "batch": 4, "classes": 2, "dropout": 0.0, "lr": 1e-3}
TRAIN_BATCHES, EVAL_BATCHES, EPOCHS = 6, 2, 3


def _setup():
    import test_torch_paddle_encoder_script as script
    from torch_nn_parity import both
    jp, tp = both()
    jp.seed(0)
    init = {k: np.asarray(v.numpy()) for k, v in
            script.build_model(jp, CFG).state_dict().items()}
    return script, jp, tp, init


def _close_logs(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (list, tuple)):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{what} {k}")
        elif isinstance(w, float):
            assert abs(g - w) <= 1e-5 * max(abs(w), 1e-6), (what, k, g, w)
        else:
            assert g == w, (what, k)


def _arrays(net):
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in net.state_dict().items()}


def test_fit_evaluate_predict_match_jax(tmp_path):
    """Up to three epochs of six steps with an evaluation after each;
    EarlyStopping (patience 0, an improvement of 1e9 asked for) stops after
    the second evaluation and restores the first's weights in both. Losses
    within 1e-5 relative a step, every callback event in the same order
    with the same logs, the parameters by ``_assert_matches`` (the key
    biases by LAMB's bound), ModelCheckpoint's files, then evaluate and
    predict on the result, the summary's totals."""
    from test_torch_train import _assert_matches
    script, jp, tp, init = _setup()
    runs = {}
    for P in (jp, tp):
        model = make_model(P, script, CFG, init=init)
        train = samples(P, CFG, TRAIN_BATCHES, 1)
        evald = samples(P, CFG, EVAL_BATCHES, 2)
        save = tmp_path / P.__name__
        hist, events, early = fit_run(P, model, train, evald, CFG["batch"],
                                      str(save), epochs=EPOCHS, patience=0,
                                      min_delta=1e9)
        res = model.evaluate(evald, batch_size=CFG["batch"], verbose=0)
        pred = model.predict(evald, batch_size=CFG["batch"])
        runs[P] = {"hist": hist, "events": events, "early": early,
                   "files": sorted(os.listdir(save)), "eval": res,
                   "pred": np.concatenate([p.numpy() for p in pred]),
                   "params": _arrays(model.network),
                   "summary": model.summary()}
    got, want = runs[tp], runs[jp]
    np.testing.assert_allclose(got["hist"]["loss"], want["hist"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["hist"]["eval_loss"],
                               want["hist"]["eval_loss"], rtol=1e-5)
    assert [e[:-1] for e in got["events"]] == \
        [e[:-1] for e in want["events"]]
    for g, w in zip(got["events"], want["events"]):
        _close_logs(g[-1], w[-1], g[:-1])
    stops = [e[1] for e in got["events"] if e[0] == "epoch_end"]
    assert stops == [0, 1] and got["early"].wait == want["early"].wait == 1
    assert got["files"] == want["files"] == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    steps = TRAIN_BATCHES      # the first evaluation's weights
    keep = [n for n in want["params"] if not n.endswith(
        script.K_BIAS)]
    _assert_matches("Model.fit", (got["hist"]["loss"][:steps], {
        n: got["params"][n] for n in keep}), (want["hist"]["loss"][:steps], {
            n: want["params"][n] for n in keep}))
    for n in want["params"]:
        if n.endswith(script.K_BIAS):
            for run in (got, want):
                moved = np.abs(run["params"][n] - init[n]).max()
                assert moved <= steps * CFG["lr"] * (1 + 1e-3), n
    _close_logs(got["eval"], want["eval"], "evaluate")
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-5,
                               atol=1e-5)
    assert got["summary"] == want["summary"]


def test_save_load_and_train_batch_metric(tmp_path):
    """``save`` then ``load`` into a fresh model: predict bit for bit, and
    the optimizer's file written; the logged accuracy equals the one
    recomputed from the step's logits."""
    script, _, tp, init = _setup()
    model = make_model(tp, script, CFG, init=init)
    data = samples(tp, CFG, 2, 3)
    out = model.predict(data, batch_size=CFG["batch"])
    path = str(tmp_path / "ckpt")
    model.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    tp.seed(7)
    fresh = make_model(tp, script, CFG)
    fresh.load(path)
    again = fresh.predict(data, batch_size=CFG["batch"])
    for a, b in zip(out, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ids = np.stack([data[i][0] for i in range(CFG["batch"])])
    labels = np.stack([data[i][1] for i in range(CFG["batch"])])
    logits = fresh.predict_batch(tp.to_tensor(ids)).numpy()
    fresh.network.eval()
    _, (acc,) = fresh.eval_batch(tp.to_tensor(ids), tp.to_tensor(labels))
    assert acc == float(np.mean(logits.argmax(-1) == labels))
