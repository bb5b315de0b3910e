"""The port's ``CheckpointManager`` (``paddle_tpu_torch.elastic``): a
Paddle-API MLP with AdamW and an LR schedule resumes bit for bit in a
model built after it (other parameter names, remapped by position); the
step and wall-clock cadence under an injected clock; steps lost from
``PROGRESS``; ``/healthz`` staleness; save errors recorded, never raised;
a preemption signal saves at the next step boundary (or, with no boundary
in time, where the loop is); the ``paddle_ckpt_*`` families are the
reference's; and a checkpoint of ``paddle_tpu``'s manager resumes in the
port at the train rule, with the RNG entries of each package left alone
by the other (pinned both ways).
"""
import os
import signal
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.elastic import CheckpointManager as JManager
from paddle_tpu.framework import random as jrandom
from paddle_tpu.observability import goodput as jgood
from paddle_tpu.observability.registry import default_registry as jreg
from paddle_tpu_torch.elastic import CheckpointManager, latest_checkpoint
from paddle_tpu_torch.elastic import manager as pmanager
from paddle_tpu_torch.framework import checkpoint as pck
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.observability import goodput as pgood
from paddle_tpu_torch.observability import httpd as phttpd
from paddle_tpu_torch.observability.registry import default_registry as preg

# the train rule: the port's steps against the reference's
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def cpu_and_fresh_ledgers():
    tp.set_device("cpu")
    prev = (pgood.set_default_ledger(pgood.GoodputLedger()),
            jgood.set_default_ledger(jgood.GoodputLedger()))
    yield
    pgood.set_default_ledger(prev[0])
    jgood.set_default_ledger(prev[1])


def _build(pk, seed):
    pk.seed(seed)
    model = pk.nn.Sequential(pk.nn.Linear(8, 16), pk.nn.Tanh(),
                             pk.nn.Linear(16, 8))
    sched = pk.optimizer.lr.StepDecay(learning_rate=0.05, step_size=2,
                                      gamma=0.5)
    opt = pk.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters(),
                             weight_decay=0.01)
    return model, opt, sched


def _port_step(model, opt, sched, step):
    """Inputs from a per-step RandomState, targets from numpy's global
    RNG, input noise from the port's generator."""
    rs = np.random.RandomState(100 + step)
    x = rs.randn(4, 8).astype(np.float32)
    target = np.random.randn(4, 8).astype(np.float32)
    noise = torch.randn((4, 8), generator=trandom.default_generator()
                        .for_device("cpu")).numpy()
    out = model(tp.to_tensor(x + 0.01 * noise))
    loss = ((out - tp.to_tensor(target)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return float(loss)


def _params(model):
    return {k: v._data.detach().clone() for k, v in
            model.state_dict().items()}


def _moments(opt):
    """Every accumulator, by parameter position (the names differ)."""
    return [opt._accumulators[an][id(p)].clone()
            for p in opt._parameters for an in opt._accum_names]


def test_resume_is_bitwise_in_a_model_built_after(tmp_path):
    trandom.seed(11)     # first: making the generator draws from numpy
    np.random.seed(7)
    model, opt, sched = _build(tp, 3)
    straight = [_port_step(model, opt, sched, s) for s in range(6)]
    want_p, want_m = _params(model), _moments(opt)

    trandom.seed(11)     # first: making the generator draws from numpy
    np.random.seed(7)
    model, opt, sched = _build(tp, 3)
    mgr = CheckpointManager(str(tmp_path), model=model, optimizer=opt,
                            save_interval_steps=3, async_save=True,
                            health_check=False)
    first = []
    for s in range(3):
        first.append(_port_step(model, opt, sched, s))
        mgr.step(s + 1)
    assert mgr.wait(timeout=30)
    names_saved = [opt._name(p) for p in opt._parameters]
    for s in range(3, 5):   # progress past the save, then "die"
        _port_step(model, opt, sched, s)
        mgr.step(s + 1)
    mgr.close()

    trandom.seed(999)
    np.random.seed(0)
    model2, opt2, sched2 = _build(tp, 42)     # other weights, other names
    assert [opt2._name(p) for p in opt2._parameters] != names_saved
    mgr2 = CheckpointManager(str(tmp_path), model=model2, optimizer=opt2,
                             health_check=False)
    res = mgr2.restore_latest()
    assert (res.step, res.steps_lost) == (3, 2)
    assert sched2.last_epoch == sched.last_epoch - 2 and \
        opt2._step_count == 3
    resumed = first + [_port_step(model2, opt2, sched2, s)
                       for s in range(3, 6)]
    mgr2.close()
    assert resumed == straight
    got_p = _params(model2)
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    assert all(torch.equal(a, b) for a, b in zip(_moments(opt2), want_m))
    # the restore fed the ledger: ckpt_restore and two replayed steps
    rep = pgood.default_ledger().report()
    assert rep["categories_s"]["ckpt_restore"] > 0
    assert rep["replay_steps_pending"] == 2


def _tiny(tmp_path, **kw):
    w = torch.zeros(3)
    return w, CheckpointManager(str(tmp_path), parameters={"w": w},
                                health_check=False, **kw)


def test_step_and_wall_clock_cadence(tmp_path):
    _, mgr = _tiny(tmp_path / "steps", save_interval_steps=3,
                   async_save=False, keep=0)
    saved = [s for s in range(1, 10)
             if mgr.step(s) is None and mgr.last_success_step == s]
    assert saved == [3, 6, 9]
    clock = [100.0]
    _, mgr = _tiny(tmp_path / "clock", save_interval_s=10.0,
                   async_save=False, keep=0, now=lambda: clock[0])
    seen = []
    for s, t in enumerate((100.0, 104.0, 109.9, 110.0, 115.0, 120.5), 1):
        clock[0] = t
        mgr.step(s)
        seen.append(mgr.last_success_step)
    assert seen == [1, 1, 1, 4, 4, 6]
    assert [os.path.basename(p) for p in
            pck.list_checkpoints(str(tmp_path / "clock"))] == \
        ["step_00000001", "step_00000004", "step_00000006"]


def test_steps_lost_staleness_and_errors(tmp_path, monkeypatch):
    w, mgr = _tiny(tmp_path, save_interval_steps=2, async_save=False,
                   keep=2)
    lost0 = preg().get("paddle_ckpt_steps_lost_total").value
    for s in range(1, 6):
        w.fill_(s)
        mgr.step(s)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004")
    w.fill_(-1)
    w2, mgr2 = _tiny(tmp_path)
    res = mgr2.restore_latest()
    assert (res.step, res.steps_lost) == (4, 1)
    assert torch.equal(w2, torch.full((3,), 4.0))
    assert preg().get("paddle_ckpt_steps_lost_total").value == lost0 + 1

    # staleness on the shared /healthz
    mgr2.enable_health_check(staleness_s=5.0)
    name = f"checkpoint:{os.path.basename(str(tmp_path))}"
    try:
        ok, detail = phttpd.healthz()
        assert detail["checks"][name]["ok"]
        mgr2._last_success_walltime -= 60
        ok, detail = phttpd.healthz()
        assert not ok and not detail["checks"][name]["ok"]
    finally:
        mgr2.close()
    assert name not in phttpd.healthz()[1]["checks"]

    # a failing save is recorded, not raised, sync and async alike
    errs0 = preg().get("paddle_ckpt_saves_total").labels("error").value

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(pmanager, "save_sharded", boom)
    assert mgr.save(8, block=True) is None
    assert isinstance(mgr.last_error, OSError)
    assert mgr._health()[0] is False
    monkeypatch.undo()
    monkeypatch.setattr(pck, "_write_and_commit", boom)
    h = mgr.save(10, block=False)
    mgr.async_save = True
    h = mgr.save(12)
    assert mgr.wait(timeout=30) and h.done()
    assert isinstance(mgr.last_error, OSError)
    assert preg().get("paddle_ckpt_saves_total").labels("error").value \
        == errs0 + 3
    mgr.close()


class _PrevHandler:
    """A SIGTERM disposition for the preemption handler to chain to, in
    place of the default (which would end the test process)."""

    def __enter__(self):
        self.calls = []
        self._prev = signal.signal(signal.SIGTERM,
                                   lambda s, f: self.calls.append(s))
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)


def test_preemption_saves_at_the_next_step_boundary(tmp_path):
    """A SIGTERM that lands after a step's update and before its
    ``mgr.step`` defers: the final save holds the state at the boundary,
    labelled with the step it belongs to, then the signal chains."""
    trandom.seed(11)
    np.random.seed(7)
    model, opt, sched = _build(tp, 3)
    mgr = CheckpointManager(str(tmp_path), model=model, optimizer=opt,
                            save_interval_steps=100, async_save=True,
                            health_check=False)
    with _PrevHandler() as prev:
        h = mgr.install_preemption_handlers(signals=(signal.SIGTERM,))
        _port_step(model, opt, sched, 0)
        mgr.step(1)
        rs = np.random.RandomState(101)     # step 2, up to its update
        out = model(tp.to_tensor(rs.randn(4, 8).astype(np.float32)))
        (out ** 2).mean().backward()
        opt.step()
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted and h.pending and prev.calls == []
        assert pck.list_checkpoints(str(tmp_path)) == []
        opt.clear_grad()
        sched.step()
        assert mgr.step(2) is None          # the final save, then chain
        assert prev.calls == [signal.SIGTERM] and not h.pending
        assert h.final_save_ok and h.boundary_wait_s >= 0
        want = _params(model)
        mgr.close()
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("step_00000002")
    extra = pck.load_checkpoint_extra(path)
    assert extra["train"]["reason"] == "preempt"
    assert extra["optimizer"]["@step"] == opt._step_count == 2
    loaded = pck.load_sharded(path)
    assert all(torch.equal(loaded["model/" + k], v)
               for k, v in want.items())


def test_a_signal_inside_a_save_defers_it(tmp_path, monkeypatch):
    """A SIGTERM inside a save's snapshot neither re-enters the save nor
    blocks: the save commits, and the final save runs at the next
    boundary."""
    w, mgr = _tiny(tmp_path, save_interval_steps=2, async_save=False,
                   keep=0)
    snapshot = pck._snapshot

    def signalled(*a, **k):
        os.kill(os.getpid(), signal.SIGTERM)
        return snapshot(*a, **k)

    with _PrevHandler() as prev:
        h = mgr.install_preemption_handlers(signals=(signal.SIGTERM,))
        w.fill_(1)
        mgr.step(1)
        w.fill_(2)
        monkeypatch.setattr(pck, "_snapshot", signalled)
        mgr.step(2)                          # saves, signal inside
        monkeypatch.undo()
        assert mgr.last_success_step == 2 and h.pending
        assert prev.calls == []
        w.fill_(3)
        mgr.step(3)
        assert prev.calls == [signal.SIGTERM] and h.final_save_ok
        mgr.close()
    assert [os.path.basename(p) for p in
            pck.list_checkpoints(str(tmp_path))] == \
        ["step_00000002", "step_00000003"]
    assert torch.equal(pck.load_sharded(
        latest_checkpoint(str(tmp_path)))["model/w"], torch.full((3,), 3.0))


def test_preemption_backstop_saves_where_the_loop_is(tmp_path):
    """No step boundary within the wait limit (an evaluation, say): a
    timer re-sends the signal and the handler saves the last step seen
    where the main thread is, then chains, as the reference does."""
    w, mgr = _tiny(tmp_path, save_interval_steps=100, async_save=True)
    with _PrevHandler() as prev:
        h = mgr.install_preemption_handlers(signals=(signal.SIGTERM,))
        h._wait_limit_s = 0.2
        w.fill_(5)
        mgr.step(1)
        os.kill(os.getpid(), signal.SIGTERM)
        t_end = time.monotonic() + 10
        while not prev.calls and time.monotonic() < t_end:
            time.sleep(0.01)                 # no boundary comes
        assert prev.calls == [signal.SIGTERM] and not h.pending
        assert h.final_save_ok and h.boundary_wait_s >= 0.2
        mgr.close()
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000001")


def _families(reg):
    return {f.name: (f.kind, tuple(f.labelnames), f.help)
            for f in reg._families.values() if f.name.startswith(
                ("paddle_ckpt_", "paddle_goodput_"))}


def test_ckpt_families_are_the_reference(tmp_path):
    """Drive both managers through a save, a quarantined corrupt
    checkpoint, a restore with steps lost and a preemption signal count;
    the families they register carry the reference's names, kinds, labels
    and help."""
    for pk, Manager, ck, tag in (
            (tp, CheckpointManager, pck, "port"),
            (jp, JManager, None, "ref")):
        d = str(tmp_path / tag)
        model, opt, _ = _build(pk, 1)
        mgr = Manager(d, model=model, optimizer=opt, save_interval_steps=1,
                      async_save=False, health_check=False)
        for s in (1, 2, 3):
            mgr.step(s)
        meta = os.path.join(d, "step_00000003", "meta.json")
        os.unlink(meta)
        res = mgr.restore_latest()
        assert res.step == 2 and res.steps_lost == 1
        mgr.close()
        from importlib import import_module
        pre = import_module(f"{pk.__name__}.elastic.preemption")
        pre._preemption_counter().labels("SIGTERM").inc(0)
    got, want = _families(preg()), _families(jreg())
    ckpt = sorted(n for n in want if n.startswith("paddle_ckpt_"))
    assert ckpt == [
        "paddle_ckpt_bytes", "paddle_ckpt_corrupt_total",
        "paddle_ckpt_last_success_step", "paddle_ckpt_preemptions_total",
        "paddle_ckpt_restore_ms", "paddle_ckpt_save_ms",
        "paddle_ckpt_saves_total", "paddle_ckpt_steps_lost_total"]
    assert {n: got[n] for n in ckpt} == {n: want[n] for n in ckpt}


def _ref_step(model, opt, sched, step):
    rs = np.random.RandomState(100 + step)
    x = rs.randn(4, 8).astype(np.float32)
    target = np.random.randn(4, 8).astype(np.float32)
    out = model(jp.to_tensor(x))
    loss = ((out - jp.to_tensor(target)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return float(loss)


def _port_step_no_noise(model, opt, sched, step):
    rs = np.random.RandomState(100 + step)
    x = rs.randn(4, 8).astype(np.float32)
    target = np.random.randn(4, 8).astype(np.float32)
    out = model(tp.to_tensor(x))
    loss = ((out - tp.to_tensor(target)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return float(loss)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "ref")
    np.random.seed(5)
    model, opt, sched = _build(jp, 2)
    mgr = JManager(d, model=model, optimizer=opt, save_interval_steps=3,
                   async_save=False, health_check=False)
    for s in range(3):
        _ref_step(model, opt, sched, s)
        mgr.step(s + 1)
    mgr.close()
    np_at_save = np.random.get_state()
    want = [_ref_step(model, opt, sched, s) for s in range(3, 6)]
    want_p = {k: np.asarray(v.numpy()) for k, v in
              model.state_dict().items()}

    trandom.seed(77)
    np.random.seed(123)
    pmodel, popt, psched = _build(tp, 9)
    gen_before = trandom.default_generator().get_state()
    pmgr = CheckpointManager(d, model=pmodel, optimizer=popt,
                             health_check=False)
    with pytest.warns(RuntimeWarning, match="JAX key"):
        res = pmgr.restore_latest()
    pmgr.close()
    assert res.step == 3 and popt._step_count == 3
    # numpy's RNG is the reference's at its save; the port's generator
    # is left as it was
    got_np = np.random.get_state()
    assert got_np[0] == np_at_save[0] and \
        np.array_equal(got_np[1], np_at_save[1]) and \
        got_np[2:] == np_at_save[2:]
    gen_after = trandom.default_generator().get_state()
    assert gen_after["seed"] == gen_before["seed"] and all(
        torch.equal(gen_after["states"][k], v)
        for k, v in gen_before["states"].items())
    got = [_port_step_no_noise(pmodel, popt, psched, s) for s in range(3, 6)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for k, v in pmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=RTOL,
                                   atol=ATOL)


def test_port_checkpoint_in_the_reference_leaves_its_rng(tmp_path):
    """The other direction: the reference's manager restores the model
    and the optimizer from a port checkpoint and skips its RNG block
    (there is no ``rng/device_key``), numpy's state included: a quirk of
    the reference the port does not copy (the port restores numpy's state
    from either package)."""
    d = str(tmp_path / "port")
    trandom.seed(3)
    np.random.seed(5)
    model, opt, sched = _build(tp, 2)
    mgr = CheckpointManager(d, model=model, optimizer=opt,
                            save_interval_steps=2, async_save=False,
                            health_check=False)
    for s in range(2):
        _port_step(model, opt, sched, s)
        mgr.step(s + 1)
    mgr.close()
    names = set(pck.load_sharded(latest_checkpoint(d)))
    assert "rng/device_key" not in names and "rng/np_keys" in names
    assert "rng/torch/cpu" in names
    want_p = {k: v.numpy() for k, v in model.state_dict().items()}

    np.random.seed(321)
    np_before = np.random.get_state()
    jmodel, jopt, _ = _build(jp, 4)
    key_before = np.asarray(jrandom.default_generator().get_state()[2])
    jmgr = JManager(d, model=jmodel, optimizer=jopt, health_check=False)
    res = jmgr.restore_latest()
    jmgr.close()
    assert res.step == 2 and jopt._step_count == 2
    for k, v in jmodel.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()), want_p[k])
    assert np.array_equal(
        np.asarray(jrandom.default_generator().get_state()[2]), key_before)
    np_after = np.random.get_state()
    assert np.array_equal(np_after[1], np_before[1]) and \
        np_after[2] == np_before[2]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # the port's own checkpoint restores its generator silently
        trandom.seed(1)
        pmodel, popt, _ = _build(tp, 6)
        pm = CheckpointManager(d, model=pmodel, optimizer=popt,
                               health_check=False)
        pm.restore_latest()
        pm.close()
