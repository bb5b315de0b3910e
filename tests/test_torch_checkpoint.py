"""Port parity for training state across a stop: ``framework/io.py``'s
``save``/``load`` and ``convert.load_paddle_training_state`` against
``paddle_tpu``'s ``paddle.save``/``paddle.load`` and ``TrainStep``, on the
CPU.

Which direction each file format is held to:

- the reference's files (``paddle.save``) load in the port, bfloat16
  accumulators included. The reference pickles those as ``ml_dtypes``
  arrays, so reading them needs ``ml_dtypes`` (this machine has it; the
  machine that runs the port on the card does not, and does not read them);
- the port's files (``framework.io.save``) load in the port bit for bit,
  bfloat16 included, and hold no ``ml_dtypes`` array: bfloat16 is written as
  its exact float32 widening with a ``"dtype": "bfloat16"`` tag, so the
  card's machine reads them;
- the reference reads the port's files too (``paddle.load``): the same
  values, bfloat16 widened to float32.

A run resumed in the port from the reference's checkpoint equals the
reference's uninterrupted run at ``test_torch_train``'s float32 rule (rtol
2e-4 / atol 2e-5; the qkv bias's key slots to Adam's bound).
"""
import pickle

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.framework import random as random_mod
from paddle_tpu_torch.framework.io import load, save
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny)
from paddle_tpu_torch.nn.functional import dropout
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr
from test_torch_train import (_arrays, _assert_matches, _ids, _jax_model,
                              _port_model)

LR = 1e-3


def _jax_run(ids, steps, moment_dtype="float32"):
    """The reference: gpt_tiny, AdamW under a cosine schedule, a
    GradScaler (scale doubling every 2 good steps), ``steps`` steps."""
    jm = _jax_model()
    sched = paddle.optimizer.lr.CosineAnnealingDecay(learning_rate=LR,
                                                     T_max=10)
    opt = paddle.optimizer.AdamW(learning_rate=sched,
                                 parameters=jm.parameters(),
                                 moment_dtype=moment_dtype)
    scaler = JGradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    crit = JCriterion()
    step = JTrainStep(jm, lambda o, y: crit(o, y), opt, scaler=scaler)
    t = paddle.to_tensor(ids)
    losses = []
    for _ in range(steps):
        losses.append(float(step(t, t).numpy()))
        sched.step()
    return jm, opt, scaler, step, sched, losses


def _port_parts(init, moment_dtype="float32"):
    pm = _port_model(init)
    sched = plr.CosineAnnealingDecay(learning_rate=LR, T_max=10)
    opt = AdamW(learning_rate=sched, parameters=pm.named_parameters(),
                moment_dtype=moment_dtype)
    scaler = GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    crit = GPTPretrainingCriterion()
    step = TrainStep(pm, lambda o, y: crit(o, y), opt, scaler=scaler)
    return pm, opt, scaler, step, sched


def _port_steps(step, sched, ids, n):
    t = torch.from_numpy(ids)
    out = []
    for _ in range(n):
        out.append(float(step(t, t)))
        sched.step()
    return out


def test_reference_files_load_in_the_port(tmp_path):
    """paddle.save's model and optimizer files (bf16 moments as ml_dtypes
    arrays) load as CPU tensors with their values and dtypes; return_numpy
    gives the stored arrays."""
    ids = _ids(20)
    jm, opt, scaler, _, _, _ = _jax_run(ids, 1, moment_dtype="bfloat16")
    paddle.save(jm.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    model = load(str(tmp_path / "m.pdparams"))
    for n, p in jm.state_dict().items():
        assert model[n].dtype == torch.float32
        np.testing.assert_array_equal(model[n].numpy(), np.asarray(p._data))
    state = load(str(tmp_path / "m.pdopt"))
    moments = [k for k in state if k.endswith("_moment1")]
    assert moments and all(state[k].dtype == torch.bfloat16 for k in moments)
    want = opt.state_dict()
    for k in moments:
        np.testing.assert_array_equal(
            state[k].float().numpy(),
            np.asarray(want[k]._data).astype(np.float32))
    assert state["@step"] == 1 and "LR_Scheduler" in state
    raw = load(str(tmp_path / "m.pdopt"), return_numpy=True)
    assert raw[moments[0]].dtype.name == "bfloat16"


def test_port_files_round_trip_bit_for_bit_and_need_no_ml_dtypes(tmp_path):
    """The port's own checkpoint (model, optimizer with bf16 moments and
    its schedule and step, scaler, generator) reloads into fresh objects
    bit for bit, and its pickle holds no ml_dtypes array."""
    init = _arrays(_jax_model())
    pm, opt, scaler, step, sched = _port_parts(init, "bfloat16")
    random_mod.seed(5)
    _port_steps(step, sched, _ids(21), 3)
    files = {k: str(tmp_path / f"ckpt.{k}") for k in ("pdparams", "pdopt",
                                                       "pdscaler", "pdrng")}
    save(pm.state_dict(), files["pdparams"])
    save(opt.state_dict(), files["pdopt"])
    save(scaler.state_dict(), files["pdscaler"])
    save(random_mod.get_rng_state(), files["pdrng"])
    x = torch.ones(256)
    after = dropout(x, 0.5)
    for f in files.values():
        with open(f, "rb") as fh:
            assert b"ml_dtypes" not in fh.read()
    qm, qopt, qscaler, _, qsched = _port_parts(_arrays(_jax_model()),
                                               "bfloat16")
    random_mod.seed(99)
    qm.load_state_dict(load(files["pdparams"]))
    qopt.set_state_dict(load(files["pdopt"]))
    qscaler.load_state_dict(load(files["pdscaler"]))
    random_mod.set_rng_state(load(files["pdrng"]))
    for (n, p), (_, q) in zip(pm.named_parameters(), qm.named_parameters()):
        assert torch.equal(p, q), n
    a, b = opt.state_dict(), qopt.state_dict()
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == b[k].dtype == torch.bfloat16 and \
                torch.equal(v, b[k]), k
        else:
            assert v == b[k], k
    assert qscaler.state_dict() == scaler.state_dict()
    assert qsched.last_epoch == sched.last_epoch == 3
    # the generator continues where the saved run stood
    assert torch.equal(dropout(x, 0.5), after)


def test_reference_reads_port_files(tmp_path):
    """paddle.load reads the port's file: the same values, bfloat16
    widened to float32 (the tag the port adds is ignored)."""
    w = torch.from_numpy(np.random.RandomState(22).randn(4, 3).astype(
        np.float32))
    state = {"w": w, "m": w.to(torch.bfloat16), "@step": 7}
    save(state, str(tmp_path / "x.pdopt"))
    got = paddle.load(str(tmp_path / "x.pdopt"))
    np.testing.assert_array_equal(np.asarray(got["w"]._data), w.numpy())
    np.testing.assert_array_equal(np.asarray(got["m"]._data),
                                  w.to(torch.bfloat16).float().numpy())
    assert got["@step"] == 7
    back = load(str(tmp_path / "x.pdopt"))
    assert back["m"].dtype == torch.bfloat16 and torch.equal(
        back["m"], state["m"])
    with open(tmp_path / "x.pdopt", "rb") as f:
        raw = pickle.load(f)
    assert raw["m"]["__tensor__"] and raw["m"]["name"] == "m"


def test_resume_from_reference_checkpoint_matches_reference(tmp_path):
    """The reference trains 2 steps (AdamW, cosine schedule, GradScaler)
    and saves; the port loads that checkpoint (weights, accumulators keyed
    by the reference's parameter names, LR_Scheduler, @step, the scaler)
    and trains 2 more; the result equals the reference's 4 steps."""
    ids = _ids(23)
    jm, opt, scaler, step, sched, first = _jax_run(ids, 2)
    init = _arrays(_jax_model())
    paddle.save(jm.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    paddle.save(scaler.state_dict(), str(tmp_path / "m.pdscaler"))
    t = paddle.to_tensor(ids)
    rest = []
    for _ in range(2):
        rest.append(float(step(t, t).numpy()))
        sched.step()
    pm, popt, pscaler, pstep, psched = _port_parts(init)
    convert.load_paddle_training_state(
        pm, popt, str(tmp_path / "m.pdparams"), str(tmp_path / "m.pdopt"),
        scaler=pscaler, scaler_file=str(tmp_path / "m.pdscaler"))
    assert popt._step_count == 2 and psched.last_epoch == 2
    assert pscaler.state_dict() == {"scale": 2.0 ** 11, "incr_ratio": 2.0,
                                    "decr_ratio": 0.5, "incr_count": 0,
                                    "decr_count": 0}
    got = _port_steps(pstep, psched, ids, 2)
    _assert_matches("resumed from the reference",
                    (got, convert.export_jax_state(pm)),
                    (rest, _arrays(jm)), init, steps=4, lr=LR)
    assert popt._step_count == 4
    assert pscaler.state_dict()["scale"] == scaler.state_dict()["scale"]


def test_load_paddle_state_still_reads_model_files(tmp_path):
    """convert.load_paddle_state (numpy, containers kept) reads the same
    files as framework.io.load."""
    paddle.seed(0)
    jm = _jax_model()
    paddle.save(jm.state_dict(), str(tmp_path / "m.pdparams"))
    a = convert.load_paddle_state(str(tmp_path / "m.pdparams"))
    b = load(str(tmp_path / "m.pdparams"), return_numpy=True)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    convert.load_jax_state(GPTForCausalLM(gpt_tiny(), device="cpu"), a)


def test_exported_state_is_a_copy():
    """convert.export_jax_state hands back copies: a float32 CPU model's
    arrays used to share the parameters' memory, so a later step changed
    an earlier export (a comparison of before and after then saw no
    change)."""
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    before = convert.export_jax_state(m)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
    after = convert.export_jax_state(m)
    for n in before:
        np.testing.assert_array_equal(after[n], before[n] + 1.0, err_msg=n)
