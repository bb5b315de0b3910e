"""The port's goodput ledger and training telemetry
(``paddle_tpu_torch.observability.{goodput,training}``) against
``paddle_tpu``'s: ledgers driven by the same begin/end/record/arm_replay
calls under one injected clock give equal reports and equal Prometheus
text; ``TrainingTelemetryCallback`` and ``instrument_optimizers`` move the
same families over a ``Model.fit`` of the same model; the port's
``TrainStep`` adds one ``train`` envelope and one ``step`` frame a call.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.observability import exposition as jexp
from paddle_tpu.observability import goodput as jgood
from paddle_tpu.observability import registry as jreg
from paddle_tpu.observability import stepprof as jprof
from paddle_tpu.observability import training as jtrain
from paddle_tpu_torch.observability import exposition as pexp
from paddle_tpu_torch.observability import goodput as pgood
from paddle_tpu_torch.observability import registry as preg
from paddle_tpu_torch.observability import stepprof as pprof
from paddle_tpu_torch.observability import training as ptrain

SIDES = {"port": (pgood, preg, pexp, pprof, ptrain, tp),
         "ref": (jgood, jreg, jexp, jprof, jtrain, jp)}


def _drive(ledger, clock):
    """Frames nested and flat, recordings inside and outside them, a
    replay armed for three step frames (the third nested in a restore),
    an ``end()`` with no open frame and an unknown category."""
    clock[0] = 100.0
    ledger.start()
    clock[0] = 101.0
    with ledger.timed("step"):
        clock[0] = 101.5
        ledger.record("compile", 0.25)
        clock[0] = 103.0
    ledger.record("data_stall", 0.5)
    ledger.begin("ckpt_save")
    clock[0] = 103.75
    ledger.end()
    ledger.arm_replay(3)
    for t in (105.0, 106.5):
        ledger.begin("step")
        clock[0] = t
        ledger.end()
    ledger.begin("ckpt_restore")
    ledger.begin("step")       # nested: the restore gets only its own
    clock[0] = 107.0
    ledger.end()
    clock[0] = 108.0
    ledger.end()
    clock[0] = 110.0
    assert ledger.end() == 0.0   # no open frame
    with pytest.raises(ValueError):
        ledger.record("bogus", 1.0)


def test_ledger_report_and_text_equal_reference():
    out = {}
    for tag, (good, reg, exp, _, _, _) in SIDES.items():
        clock = [0.0]
        r = reg.MetricRegistry()
        ledger = good.GoodputLedger(registry=r, now=lambda: clock[0])
        _drive(ledger, clock)
        out[tag] = (ledger.report(), exp.prometheus_text(r),
                    ledger.report(tolerance=0.0))
    assert out["port"] == out["ref"]
    rep = out["port"][0]
    assert rep["accounting"]["closes"] and rep["elapsed_s"] == 10.0
    assert rep["replay_steps_pending"] == 0
    assert rep["categories_s"]["recovery"] == 3.25
    assert "paddle_goodput_seconds_total{category=\"idle\"}" in out["port"][1]


def _mlp(pk):
    """The same MLP in either package, with the same weights."""
    net = pk.nn.Sequential(pk.nn.Linear(6, 12), pk.nn.ReLU(),
                           pk.nn.Linear(12, 3))
    rs = np.random.RandomState(4)
    net.set_state_dict({k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
                        for k, v in net.state_dict().items()})
    return net


class _Data:
    def __init__(self, n=12):
        rs = np.random.RandomState(0)
        self.x = rs.randn(n, 6).astype(np.float32)
        self.y = rs.randint(0, 3, (n, 1)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _families(reg, prefixes):
    return {f.name: (f.kind, tuple(f.labelnames), f.help,
                     sorted(tuple(sorted(lbl.items()))
                            for lbl, _ in f.collect()))
            for f in reg.collect() if f.name.startswith(prefixes)}


def test_fit_telemetry_moves_the_reference_families():
    tp.set_device("cpu")
    got = {}
    for tag, (good, reg, _, prof, train, pk) in SIDES.items():
        r = reg.MetricRegistry()
        clock = [0.0]
        ledger = good.GoodputLedger(registry=reg.MetricRegistry(),
                                    now=lambda: clock[0])
        cb = train.TrainingTelemetryCallback(
            registry=r, batch_size=4, ledger=ledger,
            step_profiler=prof.StepProfiler(registry=reg.MetricRegistry()))
        train.uninstrument_optimizers()
        assert train.instrument_optimizers(registry=r)
        try:
            net = _mlp(pk)
            model = pk.Model(net)
            opt = pk.optimizer.AdamW(learning_rate=0.01,
                                     parameters=net.parameters())
            model.prepare(opt, pk.nn.CrossEntropyLoss())
            model.fit(_Data(), batch_size=4, epochs=2, shuffle=False,
                      verbose=0, callbacks=[cb])
        finally:
            train.uninstrument_optimizers()
        steps = r.get("paddle_training_steps_total").value
        opt_steps = r.get("paddle_optimizer_steps_total").labels(
            optimizer="AdamW").value
        got[tag] = (_families(r, ("paddle_training_", "paddle_optimizer_")),
                    steps, opt_steps,
                    r.get("paddle_training_epochs_total").value,
                    r.get("paddle_optimizer_params").labels(
                        optimizer="AdamW").value,
                    r.get("paddle_training_loss").value,
                    len(cb._prof.envelopes(kind="train")))
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0]
    assert port[1:5] == ref[1:5] == (6, 6, 2, 4)
    np.testing.assert_allclose(port[5], ref[5], rtol=2e-4, atol=2e-5)
    assert port[6] == ref[6] == 6


class _CountingLedger(pgood.GoodputLedger):
    def __init__(self):
        super().__init__(registry=preg.MetricRegistry())
        self.frames = []

    def begin(self, category):
        self.frames.append(category)
        super().begin(category)


def test_train_step_adds_one_envelope_and_one_frame_a_call():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    ledger = _CountingLedger()
    profiler = pprof.StepProfiler(registry=preg.MetricRegistry())
    prev = (pgood.set_default_ledger(ledger),
            pprof.set_default_profiler(profiler))
    seen = []

    def observer(opt, duration_s, n_params):
        seen.append((type(opt).__name__, duration_s >= 0, n_params))
    from paddle_tpu_torch.optimizer import optimizer as opt_mod
    opt_mod.register_step_observer(observer)
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        opt = AdamW(learning_rate=1e-2, parameters=model.named_parameters())
        step = TrainStep(model, torch.nn.functional.mse_loss, opt)
        x, y = torch.randn(3, 4), torch.randn(3, 2)
        for _ in range(3):
            step(x, y)
        envs = profiler.envelopes(kind="train")
        assert [e["step"] for e in envs] == [1, 2, 3]
        assert ledger.frames == ["step"] * 3
        assert ledger.report()["categories_s"]["step"] > 0
        step.run_steps(2, x, y)      # as the reference's: neither feed
        assert len(profiler.envelopes(kind="train")) == 3
        assert ledger.frames == ["step"] * 3
        assert seen == [("AdamW", True, 2)] * 5
        opt.step()                   # step() without grads: 0 updated
        model(x).sum().backward()
        opt.step()
        assert seen[5:] == [("AdamW", True, 0), ("AdamW", True, 2)]
    finally:
        opt_mod.unregister_step_observer(observer)
        pgood.set_default_ledger(prev[0])
        pprof.set_default_profiler(prev[1])
