"""Port parity for dynamic loss scaling: ``paddle_tpu_torch.amp.GradScaler``
and ``TrainStep(..., scaler=)`` against ``paddle_tpu``'s, on the CPU.

The cases of the reference's ``tests/test_fp16_scaler_trainstep.py`` and
``tests/test_amp_io_jit.py:32-58``, run through both packages on the same
weights (``convert.py``) and seeded numpy inputs: an overflow skips the
update (parameters and moments exact) and decreases the scale after
``decr_every`` bad steps; ``incr_every`` good steps increase it; without an
overflow a scaled run equals the unscaled one (rtol 2e-4 / atol 2e-5, the
float32 rule of ``test_torch_train``: the same function, sums in another
order); a disabled scaler is inert; ``load_state_dict`` takes effect at the
next step; ``run_steps`` equals the loop; and ``gpt_tiny`` in O2 float16
keeps the reference's scale trajectory and skipped steps, its distance from
the float32 run within 1.5x the reference's own (the rounding-floor rule).
"""
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import GradScaler, auto_cast
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from test_torch_train import (O2_FACTOR, _arrays, _ids, _jax_model, _l2,
                              _port_model)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-5
B, D = 8, 16


class JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = paddle.nn.Linear(D, 32)
        self.l2 = paddle.nn.Linear(32, 1)

    def forward(self, x):
        return self.l2(paddle.nn.functional.relu(self.l1(x)))


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = nn.Linear(D, 32)
        self.l2 = nn.Linear(32, 1)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, D).astype("float32"), rng.randn(B, 1).astype(
        "float32")


def _mse(o, y):
    return ((o - y) ** 2).mean()


def _nets():
    paddle.seed(0)
    jn = JNet()
    arrays = {n: np.asarray(p._data) for n, p in jn.named_parameters()}
    return jn, convert.load_jax_state(Net(), arrays)


def _jparams(net):
    return {n: np.asarray(p.numpy()) for n, p in net.named_parameters()}


def _pparams(net):
    return convert.export_jax_state(net)


def _steps(opt_cls, lr, scaler_kw, amp_level=None, amp_dtype="float16",
           data_seed=0):
    """Both packages' Net, optimizer and TrainStep; scaler_kw None: no
    scaler."""
    jn, pn = _nets()
    jopt = getattr(paddle.optimizer, opt_cls.__name__)(
        learning_rate=lr, parameters=jn.parameters())
    popt = opt_cls(learning_rate=lr, parameters=pn.named_parameters())
    jsc = None if scaler_kw is None else JGradScaler(**scaler_kw)
    psc = None if scaler_kw is None else GradScaler(**scaler_kw)
    kw = dict(amp_level=amp_level, amp_dtype=amp_dtype)
    js = JTrainStep(jn, _mse, jopt, scaler=jsc, **kw)
    ps = TrainStep(pn, _mse, popt, scaler=psc, **kw)
    x, y = _data(data_seed)
    return (jn, js, jsc, paddle.to_tensor(x), paddle.to_tensor(y)), \
        (pn, ps, psc, torch.from_numpy(x), torch.from_numpy(y))


def test_overflow_skips_update_and_decreases_scale():
    (jn, js, jsc, jx, jy), (pn, ps, psc, px, py) = _steps(
        SGD, 1e-2, dict(init_loss_scaling=1e38, decr_every_n_nan_or_inf=1,
                        decr_ratio=0.5), amp_level="O1", data_seed=1)
    before = _pparams(pn)
    js(jx, jy)
    ps(px, py)
    after = _pparams(pn)
    for n in before:
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    assert bool(psc._found_inf) and bool(np.asarray(jsc._found_inf))
    # the schedule runs in float32 in both packages
    assert psc.state_dict()["scale"] == jsc.state_dict()["scale"]
    assert np.isclose(psc.state_dict()["scale"], 0.5e38, rtol=1e-6)
    # keep stepping: the scale halves until float16's backward fits, then
    # updates resume, after as many skipped steps in both packages
    skipped = {}
    for tag, step, net, params, x, y in (
            ("jax", js, jn, _jparams, jx, jy),
            ("port", ps, pn, _pparams, px, py)):
        start = params(net)
        for i in range(200):
            step(x, y)
            if any((params(net)[n] != start[n]).any() for n in start):
                skipped[tag] = i
                break
    assert skipped["port"] == skipped["jax"], skipped
    assert psc.state_dict()["scale"] == jsc.state_dict()["scale"] < 1e5


def test_scale_increases_after_incr_every_good_steps():
    (_, js, jsc, jx, jy), (_, ps, psc, px, py) = _steps(
        SGD, 1e-3, dict(init_loss_scaling=8.0, incr_every_n_steps=2,
                        incr_ratio=2.0), amp_level="O1", data_seed=2)
    want = [8.0, 16.0, 16.0, 32.0]
    for w in want:
        js(jx, jy)
        ps(px, py)
        assert psc.state_dict()["scale"] == jsc.state_dict()["scale"] == w
    assert psc.state_dict()["incr_count"] == jsc.state_dict()["incr_count"]


@pytest.mark.parametrize("opt_cls", [SGD, Adam])
def test_scaler_matches_unscaled_when_no_overflow(opt_cls):
    """No AMP: the scaled run's losses and parameters equal the unscaled
    one's and the reference's scaled run (rtol 2e-4 / atol 2e-5)."""
    runs = {}
    for tag, kw in (("plain", None), ("scaled", dict(
            init_loss_scaling=2.0 ** 8))):
        (jn, js, _, jx, jy), (pn, ps, _, px, py) = _steps(
            opt_cls, 1e-2, kw, data_seed=3)
        runs[tag] = ([float(ps(px, py)) for _ in range(5)], _pparams(pn))
        runs[f"jax_{tag}"] = ([float(js(jx, jy).numpy()) for _ in range(5)],
                              _jparams(jn))
    for other in ("plain", "jax_scaled"):
        np.testing.assert_allclose(runs["scaled"][0], runs[other][0],
                                   rtol=RTOL, atol=ATOL, err_msg=other)
        for n, p in runs[other][1].items():
            np.testing.assert_allclose(runs["scaled"][1][n], p, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{other} {n}")


def test_disabled_scaler_is_inert():
    (_, _, _, _, _), (pn, ps, _, px, py) = _steps(
        SGD, 1e-2, dict(enable=False), data_seed=4)
    (_, _, _, _, _), (qn, qs, _, _, _) = _steps(SGD, 1e-2, None, data_seed=4)
    losses = [float(ps(px, py)) for _ in range(3)]
    plain = [float(qs(px, py)) for _ in range(3)]
    assert losses == plain and losses[-1] < losses[0]
    for n, p in _pparams(qn).items():
        np.testing.assert_array_equal(_pparams(pn)[n], p, err_msg=n)
    assert ps._scaler is None


def test_scaler_load_state_dict_takes_effect_mid_training():
    (_, js, jsc, jx, jy), (_, ps, psc, px, py) = _steps(
        SGD, 1e-2, dict(init_loss_scaling=256.0), data_seed=5)
    js(jx, jy)
    ps(px, py)
    assert psc.state_dict()["scale"] == jsc.state_dict()["scale"] == 256.0
    new = {"scale": 1024.0, "incr_count": 0, "decr_count": 0}
    jsc.load_state_dict(new)
    psc.load_state_dict(new)
    js(jx, jy)
    ps(px, py)
    assert psc.state_dict()["scale"] == jsc.state_dict()["scale"] == 1024.0
    assert psc.state_dict()["incr_count"] == 1


def test_run_steps_with_scaler_equals_the_loop():
    """run_steps(8) with a scaler is the loop of 8 calls, bit for bit, and
    doubles the scale twice as the reference's (incr_every 4)."""
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=4)
    (_, js, jsc, jx, jy), (pn, ps, psc, px, py) = _steps(Adam, 1e-2, kw,
                                                        data_seed=8)
    js.run_steps(8, jx, jy)
    last = ps.run_steps(8, px, py)
    (_, _, _, _, _), (qn, qs, qsc, _, _) = _steps(Adam, 1e-2, kw,
                                                  data_seed=8)
    loop = [qs(px, py) for _ in range(8)][-1]
    assert float(last) == float(loop)
    for n, p in _pparams(qn).items():
        np.testing.assert_array_equal(_pparams(pn)[n], p, err_msg=n)
    assert psc.state_dict()["scale"] == qsc.state_dict()["scale"] == \
        jsc.state_dict()["scale"] == 2.0 ** 10
    assert ps.optimizer._step_count == 8


def test_skipped_step_leaves_adam_moments_exact():
    """A step whose gradients overflow leaves Adam's moments (and the
    parameters) bit for bit as they were; t still advances, as the
    reference's in-graph branch."""
    (_, _, _, _, _), (pn, ps, psc, px, py) = _steps(
        Adam, 1e-2, dict(init_loss_scaling=2.0 ** 8,
                         decr_every_n_nan_or_inf=2), data_seed=9)
    ps(px, py)
    opt = ps.optimizer
    moments = {(an, pid): t.clone() for an, store in
               opt._accumulators.items() for pid, t in store.items()}
    params = _pparams(pn)
    psc.load_state_dict({"scale": float("inf")})
    ps(px, py)
    assert bool(psc._found_inf)
    for key, t in moments.items():
        assert torch.equal(opt._accumulators[key[0]][key[1]], t), key
    for n, p in params.items():
        np.testing.assert_array_equal(_pparams(pn)[n], p, err_msg=n)
    assert opt._step_count == 2
    assert psc.state_dict()["decr_count"] == 1


# ------------------------------------------ the eager protocol (test_amp_io)
def test_eager_roundtrip_matches_reference():
    """scale(loss).backward(), step(opt), update() around the port's
    Optimizer equals the reference's eager protocol (float32, so the
    float32 tolerance holds; AMP's rounding is TrainStep's tests')."""
    jn, pn = _nets()
    x, _ = _data(10)
    jopt = paddle.optimizer.SGD(learning_rate=0.01, parameters=jn.parameters())
    popt = SGD(learning_rate=0.01, parameters=pn.named_parameters())
    jsc = paddle.amp.GradScaler(init_loss_scaling=128.0)
    psc = GradScaler(init_loss_scaling=128.0)
    jloss = jn(paddle.to_tensor(x)).sum()
    jsc.scale(jloss).backward()
    jsc.step(jopt)
    jsc.update()
    with auto_cast(enable=False):
        ploss = pn(torch.from_numpy(x)).sum()
    psc.scale(ploss).backward()
    psc.step(popt)
    psc.update()
    assert psc.state_dict() == jsc.state_dict()
    got, want = _pparams(pn), _jparams(jn)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_eager_step_skips_inf():
    jn, pn = _nets()
    x = np.array([[np.inf] + [1.0] * (D - 1)], "float32")
    w0 = _pparams(pn)
    popt = SGD(learning_rate=1.0, parameters=pn.named_parameters())
    psc = GradScaler(init_loss_scaling=64.0)
    psc.minimize(popt, psc.scale(pn(torch.from_numpy(x)).sum()))
    for n, p in w0.items():
        np.testing.assert_array_equal(_pparams(pn)[n], p, err_msg=n)
    assert psc._found_inf and psc.state_dict()["decr_count"] == 1
    # unscale_ then step unscales once (the reference's step unscales again)
    pn.zero_grad()
    psc.scale(pn(torch.from_numpy(np.ones((1, D), "float32"))).sum()
              ).backward()
    g = pn.l2.bias.grad.clone()
    psc.unscale_(popt)
    torch.testing.assert_close(pn.l2.bias.grad, g / 64.0, atol=0, rtol=0)
    psc.step(popt)
    np.testing.assert_allclose(_pparams(pn)["l2.bias"], w0["l2.bias"]
                               - g.numpy() / 64.0, rtol=1e-6)


# --------------------------------------------------- gpt_tiny in O2 float16
def _gpt_runs(scaler_kw, steps=4):
    """gpt_tiny, AdamW: the reference's float32 run, its O2 float16 run with
    a scaler, and the port's O2 float16 run with a scaler; losses,
    parameters and each step's scale and found_inf."""
    ids = _ids(11)
    jm = _jax_model()
    init = _arrays(jm)
    out = {}
    for tag, amp in (("jax_f32", None), ("jax_f16", "O2")):
        jm = _jax_model()
        crit = paddle.models.GPTPretrainingCriterion()
        opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=jm.parameters())
        sc = JGradScaler(**scaler_kw) if amp else None
        step = JTrainStep(jm, lambda o, y: crit(o, y), opt, amp_level=amp,
                          amp_dtype="float16", scaler=sc)
        t = paddle.to_tensor(ids)
        losses, scales, found = [], [], []
        for _ in range(steps):
            losses.append(float(step(t, t).numpy()))
            if sc is not None:
                scales.append(sc.state_dict()["scale"])
                found.append(bool(np.asarray(sc._found_inf)))
        out[tag] = (losses, _arrays(jm), scales, found)
    m = _port_model(init)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters())
    sc = GradScaler(**scaler_kw)
    step = TrainStep(m, lambda o, y: crit(o, y), opt, amp_level="O2",
                     amp_dtype="float16", scaler=sc)
    t = torch.from_numpy(ids)
    losses, scales, found = [], [], []
    for _ in range(steps):
        losses.append(float(step(t, t)))
        scales.append(sc.state_dict()["scale"])
        found.append(bool(sc._found_inf))
    out["port_f16"] = (losses, convert.export_jax_state(m), scales, found)
    return out


@pytest.mark.parametrize("scaler_kw", [
    dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2),
    dict(init_loss_scaling=2.0 ** 20, decr_every_n_nan_or_inf=1)],
    ids=["incr", "overflow_then_decr"])
def test_gpt_tiny_o2_float16_matches_reference(scaler_kw):
    runs = _gpt_runs(scaler_kw)
    fl, fp, _, _ = runs["jax_f32"]
    jl, jp, js, jf = runs["jax_f16"]
    pl, pp, ps, pf = runs["port_f16"]
    assert ps == js and pf == jf, (ps, js, pf, jf)
    assert not all(jf), "every step overflowed"
    ref_loss = max(abs(jl[i] - fl[i]) for i in range(len(fl)))
    port_loss = max(abs(pl[i] - fl[i]) for i in range(len(fl)))
    if any(jf):
        # skipped steps: the float32 run has moved on; only the trajectory
        # (scales, found_inf) and finite losses are compared
        assert all(np.isfinite(pl))
        return
    ref_par, port_par = _l2(jp, fp), _l2(pp, fp)
    assert 0 < ref_loss and 0 < ref_par
    assert port_loss <= O2_FACTOR * ref_loss, (port_loss, ref_loss)
    assert port_par <= O2_FACTOR * ref_par, (port_par, ref_par)
