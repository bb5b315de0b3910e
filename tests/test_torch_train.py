"""Port parity for training: ``paddle_tpu_torch``'s TrainStep, AdamW, clips,
LR schedules, criterion and AMP against ``paddle_tpu``'s, on the CPU.

Weights come from the JAX model through ``convert.py``; inputs from seeded
numpy. float32 steps are held with the tolerance of
``__graft_entry__._assert_matches_single`` (rtol 2e-4, atol 2e-5: the same
function, float32 sums in another order). bf16 (AMP O2) rounds at other
places in the two packages: on the CPU the reference's attention is its
dense path in bf16, the port's the plain version of the flash kernels, which
computes in float from bf16 inputs. O2 is therefore held by the rounding-floor
rule: the port's O2 distance from the float32 run is at most ``O2_FACTOR``
times the reference O2's own distance from it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit.train_step import _functional_clip
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny)
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.ops import cuda_attention_bwd as cab
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr

RTOL, ATOL = 2e-4, 2e-5
O2_FACTOR = 1.5
SEQ = 32


def _ids(seed=0, b=2, s=SEQ, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int64)


def _jax_model():
    paddle.seed(0)
    return JGPT(j_gpt_tiny(use_flash_attention=False))


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _port_model(arrays):
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    return convert.load_jax_state(m, arrays)


def _jax_train(steps, ids, amp_level=None, moment_dtype="float32",
               decay=None, jm=None):
    jm = jm or _jax_model()
    names = {p.name: n for n, p in jm.named_parameters()}
    fn = None if decay is None else (lambda pname: decay(names[pname]))
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=jm.parameters(),
                                 moment_dtype=moment_dtype,
                                 apply_decay_param_fun=fn)
    crit = JCriterion()
    step = JTrainStep(jm, lambda out, y: crit(out, y), opt,
                      amp_level=amp_level)
    t = paddle.to_tensor(ids)
    losses = [float(step(t, t).numpy()) for _ in range(steps)]
    return losses, _arrays(jm), jm, opt


def _port_train(arrays, steps, ids, amp_level=None, moment_dtype="float32",
                decay=None):
    m = _port_model(arrays)
    opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters(),
                moment_dtype=moment_dtype, apply_decay_param_fun=decay)
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt,
                     amp_level=amp_level)
    t = torch.from_numpy(ids)
    losses = [float(step(t, t)) for _ in range(steps)]
    return losses, convert.export_jax_state(m), m, opt


def _k_bias(name, shape):
    """The key slots of a fused qkv bias (head-major ``[nh, 3, hd]``)."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv_proj.bias"):
        mask.reshape(-1, 3, shape[0] // (3 * gpt_tiny().num_heads))[
            :, 1] = True
    return mask


def _assert_matches(tag, port, ref, init=None, steps=0, lr=1e-4):
    """Losses and every parameter within RTOL/ATOL, except the key slots
    of the qkv bias: softmax is invariant to a shift of a row's scores, so
    their exact gradient is zero and both packages hand Adam float32
    rounding noise (~1e-9, against eps 1e-8), which Adam turns into updates
    of up to ~lr/10 a step, in no agreed direction. Those slots are held to
    what Adam allows: each package moves them by at most lr a step."""
    (lp, pp), (lr_, pr) = port, ref
    np.testing.assert_allclose(lp, lr_, rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag}: losses")
    assert pp.keys() == pr.keys()
    for n in pr:
        kb = _k_bias(n, pr[n].shape)
        np.testing.assert_allclose(pp[n][~kb], pr[n][~kb], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag}: {n}")
        if kb.any():
            assert init is not None, f"{tag}: {n} needs the initial values"
            for got in (pp[n], pr[n]):
                moved = np.abs(got[kb] - init[n][kb]).max()
                assert moved <= steps * lr * (1 + 1e-3), (tag, n, moved)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_two_steps_match_jax_float32(moment_dtype):
    ids = _ids()
    init = _arrays(_jax_model())
    jl, jp, jm, _ = _jax_train(2, ids, moment_dtype=moment_dtype)
    before = dict(cab.plain_calls)
    pl, pp, _, _ = _port_train(init, 2, ids, moment_dtype=moment_dtype)
    # every layer's backward went through the flash backward's wrapper
    n_layers = gpt_tiny().num_layers
    assert all(cab.plain_calls[n] == before[n] + 2 * n_layers
               for n in cab.KERNELS)
    _assert_matches(f"AdamW {moment_dtype} moments", (pl, pp), (jl, jp),
                    init, steps=2)
    assert pl[1] < pl[0]


def test_apply_decay_param_fun_matches_jax():
    """No decay on biases and layer norms: the port names parameters by
    their ``named_parameters()`` key, the reference by its unique names;
    both decide by the same structured name."""
    def decay(name):
        return not (name.endswith(".bias") or ".ln_" in name
                    or "ln_f" in name)
    ids = _ids(3)
    init = _arrays(_jax_model())
    jl, jp, _, _ = _jax_train(2, ids, decay=decay)
    pl, pp, _, _ = _port_train(init, 2, ids, decay=decay)
    _assert_matches("AdamW apply_decay_param_fun", (pl, pp), (jl, jp), init,
                    steps=2)


def _l2(a, b):
    """The L2 norm of the difference over all parameters."""
    return float(np.sqrt(sum(np.square(a[n] - b[n]).sum() for n in b)))


def test_amp_o2_within_the_rounding_floor():
    """O2, two steps: the port's distance from the float32 run is at most
    O2_FACTOR x the reference O2's own distance from it, on the loss (the
    largest |difference| over the steps) and on the parameters (the L2 norm
    of the difference over all of them; the largest element saturates at
    two Adam steps of 2·lr in both). CPU readings, seeds 1 and 2: losses
    1.54e-3 / 1.24e-3 and 6.6e-4 / 1.19e-3, parameters 4.85e-3 / 5.23e-3
    and 4.87e-3 / 5.01e-3 (port / reference)."""
    ids = _ids(1)
    arrays = _arrays(_jax_model())
    fl, fp, _, _ = _jax_train(2, ids)
    jl, jp, _, _ = _jax_train(2, ids, amp_level="O2")
    pl, pp, _, _ = _port_train(arrays, 2, ids, amp_level="O2")
    ref_loss = max(abs(a - b) for a, b in zip(jl, fl))
    port_loss = max(abs(a - b) for a, b in zip(pl, fl))
    ref_par, port_par = _l2(jp, fp), _l2(pp, fp)
    assert 0 < ref_loss and 0 < ref_par       # O2 did round somewhere
    assert port_loss <= O2_FACTOR * ref_loss, (port_loss, ref_loss)
    assert port_par <= O2_FACTOR * ref_par, (port_par, ref_par)
    assert pl[1] < pl[0]


def test_run_steps_equals_three_calls():
    ids = _ids(2)
    arrays = _arrays(_jax_model())
    a_losses, a_params, _, a_opt = _port_train(arrays, 3, ids)
    m = _port_model(arrays)
    opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters())
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt)
    t = torch.from_numpy(ids)
    last = step.run_steps(3, t, t)
    assert opt._step_count == a_opt._step_count == 3
    assert float(last) == a_losses[-1]
    b_params = convert.export_jax_state(m)
    for n in a_params:
        np.testing.assert_array_equal(b_params[n], a_params[n], err_msg=n)


def test_run_steps_matches_jax_run_steps():
    ids = _ids(4)
    jm = _jax_model()
    arrays = _arrays(jm)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters())
    jcrit = JCriterion()
    jstep = JTrainStep(jm, lambda out, y: jcrit(out, y), jopt)
    jt = paddle.to_tensor(ids)
    jloss = float(jstep.run_steps(3, jt, jt).numpy())
    m = _port_model(arrays)
    opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters())
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt)
    t = torch.from_numpy(ids)
    loss = float(step.run_steps(3, t, t))
    assert opt._step_count == jopt._step_count == 3
    _assert_matches("run_steps(3)", ([loss], convert.export_jax_state(m)),
                    ([jloss], _arrays(jm)), arrays, steps=3)


def test_attention_branch_gets_gradients_matching_jax():
    """The repair: the attention's output carries autograd history, so
    qkv_proj and ln_1 of every layer get gradients, equal to the JAX
    package's, and the embeddings get the attention branch's share."""
    ids = _ids(5)
    jm = _jax_model()
    crit = JCriterion()
    t = paddle.to_tensor(ids)
    loss = crit(jm(t), t)
    loss.backward()
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    m = _port_model(_arrays(jm))
    pt_loss = GPTPretrainingCriterion()(m(torch.from_numpy(ids)),
                                        torch.from_numpy(ids))
    pt_loss.backward()
    np.testing.assert_allclose(pt_loss.item(), float(loss.numpy()),
                               rtol=RTOL, atol=ATOL)
    linear = {f"{n}.weight" for n, mod in m.named_modules()
              if isinstance(mod, torch.nn.Linear)}
    for n, p in m.named_parameters():
        assert p.grad is not None, n
        g = p.grad.numpy().T if n in linear else p.grad.numpy()
        np.testing.assert_allclose(g, jgrads[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    for i in range(gpt_tiny().num_layers):
        for name in (f"gpt.layers.{i}.attn.qkv_proj.weight",
                     f"gpt.layers.{i}.ln_1.weight"):
            assert float(m.get_parameter(name).grad.abs().max()) > 0, name


@pytest.mark.parametrize("moment_dtype,wd", [
    ("float32", 0.01), ("bfloat16", 0.01), ("float32", 0.0)])
def test_adamw_rule_matches_reference_update_rule(moment_dtype, wd):
    rng = np.random.RandomState(7)
    p0 = rng.randn(5, 7).astype(np.float32)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  moment_dtype=moment_dtype)
    popt = AdamW(learning_rate=1e-3, moment_dtype=moment_dtype)
    md = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moment_dtype]
    jp = jnp.asarray(p0)
    jstate = {"moment1": jnp.zeros(p0.shape, md),
              "moment2": jnp.zeros(p0.shape, md)}
    pp = torch.from_numpy(p0.copy())
    pstate = {an: [popt._get_accum(an, pp)] for an in popt._accum_names}
    for t in range(1, 4):
        g = rng.randn(5, 7).astype(np.float32)
        jp, jstate = jopt._update_rule(jp, jnp.asarray(g), jnp.float32(1e-3),
                                       jnp.int32(t), jnp.float32(wd),
                                       jstate)
        popt._update_rule([pp], [torch.from_numpy(g)], 1e-3, t, wd, pstate)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
        for an in popt._accum_names:
            got = pstate[an][0]
            assert str(got.dtype) == f"torch.{moment_dtype}"
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(jstate[an], np.float32),
                rtol=1e-6, atol=1e-7, err_msg=an)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov",
                                  "adam_l2"])
def test_other_rules_match_reference(kind):
    """SGD, Momentum (plain and Nesterov) and Adam with coupled L2 decay,
    through ``apply_gradients``, against the reference optimizers'."""
    from paddle_tpu_torch import optimizer as popt
    rng = np.random.RandomState(17)
    p0 = rng.randn(4, 5).astype(np.float32)
    make = {"sgd": lambda m, ps: m.SGD(0.1, parameters=ps),
            "momentum": lambda m, ps: m.Momentum(0.1, 0.9, parameters=ps),
            "nesterov": lambda m, ps: m.Momentum(0.1, 0.9, parameters=ps,
                                                 use_nesterov=True),
            "adam_l2": lambda m, ps: m.Adam(0.01, parameters=ps,
                                            weight_decay=0.1)}[kind]
    jp = paddle.to_tensor(p0.copy(), stop_gradient=False)
    jo = make(paddle.optimizer, [jp])
    tp = torch.from_numpy(p0.copy())
    to = make(popt, [tp])
    for _ in range(3):
        g = rng.randn(4, 5).astype(np.float32)
        jo.apply_gradients([(jp, paddle.to_tensor(g))])
        to.apply_gradients([(tp, torch.from_numpy(g))])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp._data),
                                   rtol=1e-6, atol=1e-6)
    assert to._step_count == jo._step_count == 3


def test_optimizer_state_dict_round_trip():
    w = torch.zeros(3, requires_grad=True)
    opt = AdamW(learning_rate=0.1, parameters=[("fc.weight", w)],
                moment_dtype="bfloat16")
    w.grad = torch.ones(3)
    opt.step()
    sd = opt.state_dict()
    assert sd["@step"] == 1 and sd["fc.weight_moment2"].dtype == \
        torch.bfloat16
    w2 = torch.zeros(3)
    opt2 = AdamW(learning_rate=0.1, parameters=[("fc.weight", w2)])
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1
    torch.testing.assert_close(opt2._get_accum("moment1", w2),
                               sd["fc.weight_moment1"])


def test_adamw_decay_by_name():
    w = torch.ones(3, requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    opt = AdamW(learning_rate=0.5, weight_decay=0.1,
                parameters=[("fc.weight", w), ("fc.bias", b)],
                apply_decay_param_fun=lambda n: not n.endswith("bias"))
    assert opt._wd_for(w) == 0.1 and opt._wd_for(b) == 0.0
    w.grad = torch.zeros(3)
    b.grad = torch.zeros(3)
    opt.step()
    # zero grads: only the decoupled decay moves a parameter
    np.testing.assert_allclose(w.detach().numpy(), np.float32(1 - 0.5 * 0.1))
    np.testing.assert_array_equal(b.detach().numpy(), np.ones(3))
    sd = opt.state_dict()
    assert sd["@step"] == 1 and "fc.weight_moment1" in sd


@pytest.mark.parametrize("clip", [
    ("global", 0.5), ("global", 1e3), ("norm", 0.3), ("value", 0.2)])
def test_clips_match_reference(clip):
    kind, val = clip
    rng = np.random.RandomState(11)
    grads = {f"g{i}": rng.randn(4, 3).astype(np.float32) for i in range(3)}
    jc, pc = {"global": (jclip.ClipGradByGlobalNorm,
                         ClipGradByGlobalNorm),
              "norm": (jclip.ClipGradByNorm, ClipGradByNorm),
              "value": (jclip.ClipGradByValue, ClipGradByValue)}[kind]
    want = _functional_clip(jc(val), {k: jnp.asarray(v)
                                      for k, v in grads.items()})
    params = [torch.zeros(4, 3) for _ in grads]
    got = pc(val)([(p, torch.from_numpy(g))
                   for p, g in zip(params, grads.values())])
    for (p, g), k, p0 in zip(got, grads, params):
        assert p is p0
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("make", [
    lambda m: m.LinearWarmup(m.CosineAnnealingDecay(0.1, T_max=15), 5,
                             0.0, 0.1),
    lambda m: m.CosineAnnealingDecay(0.1, T_max=7, eta_min=1e-3),
    lambda m: m.PiecewiseDecay([3, 8, 12], [0.1, 0.05, 0.01, 0.001]),
    lambda m: m.LinearWarmup(0.2, 4, 0.01, 0.2),
], ids=["warmup_cosine", "cosine", "piecewise", "warmup_const"])
def test_lr_schedules_match_over_20_steps(make):
    js, ps = make(jlr), make(plr)
    jv, pv = [], []
    for _ in range(20):
        jv.append(js())
        pv.append(ps())
        js.step()
        ps.step()
    assert pv == jv


def test_scheduler_drives_the_step_lr():
    sched = plr.PiecewiseDecay([1], [0.1, 0.01])
    opt = AdamW(learning_rate=sched)
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.01
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)


def test_criterion_with_ignored_labels_matches_jax():
    rng = np.random.RandomState(13)
    logits = rng.randn(2, 9, 17).astype(np.float32)
    labels = rng.randint(0, 17, (2, 9)).astype(np.int64)
    labels[0, 3] = labels[1, 1:5] = -100
    want = float(JCriterion()(paddle.to_tensor(logits),
                              paddle.to_tensor(labels)).numpy())
    got = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    # the mean is over the 16 - 5 labels that are not ignored
    lp = F.log_softmax(torch.from_numpy(logits)[:, :-1], -1)
    lb = torch.from_numpy(labels)[:, 1:]
    keep = lb != -100
    manual = -lp.gather(-1, lb.clamp(min=0)[..., None])[..., 0][keep].mean()
    assert int(keep.sum()) == 11
    torch.testing.assert_close(got, manual)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_optimizer_state_carries_across(moment_dtype):
    """Two JAX steps, then the weights, the moments (in their dtype) and the
    step count go across through convert.py; a third step in both packages
    agrees."""
    ids = _ids(6)
    _, _, jm, jopt = _jax_train(2, ids, moment_dtype=moment_dtype)
    arrays = _arrays(jm)
    state = {f"{n}_{an}": np.asarray(jopt._accumulators[an][id(p)])
             for n, p in jm.named_parameters() for an in jopt._accum_names}
    m = _port_model(arrays)
    opt = AdamW(learning_rate=1e-4, moment_dtype=moment_dtype)
    convert.load_jax_optimizer_state(opt, m, state, jopt._step_count)
    assert opt._step_count == 2
    mom = opt._get_accum("moment1", m.gpt.layers[0].attn.qkv_proj.weight)
    assert str(mom.dtype) == f"torch.{moment_dtype}" and \
        mom.shape == (192, 64)
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt)
    loss = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
    jcrit = JCriterion()
    jstep = JTrainStep(jm, lambda out, y: jcrit(out, y), jopt)
    jt = paddle.to_tensor(ids)
    jloss = float(jstep(jt, jt).numpy())
    assert opt._step_count == jopt._step_count == 3
    _assert_matches("third step", ([loss], convert.export_jax_state(m)),
                    ([jloss], _arrays(jm)), arrays, steps=1)


def test_auto_cast_rule():
    """O2 casts every listed op but the black-listed ones to bf16; a layer
    norm outputs float32 and the residual add stays bf16; float32 master
    weights get float32 gradients. O1 casts only the white list."""
    lin = torch.nn.Linear(8, 8)
    ln = torch.nn.LayerNorm(8)
    x = torch.randn(2, 8)
    with auto_cast(level="O2"):
        h = ln(x)
        y = lin(h)
        z = y + y
        emb = F.embedding(torch.tensor([1, 2]), lin.weight)
        ce = cross_entropy(y, torch.tensor([1, 2]))
        with auto_cast(enable=False):
            plain = lin(h)
    assert h.dtype == torch.float32 and y.dtype == torch.bfloat16
    assert z.dtype == torch.bfloat16 and emb.dtype == torch.bfloat16
    assert ce.dtype == torch.float32 and plain.dtype == torch.float32
    y.float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    with auto_cast(level="O1"):
        e1 = F.embedding(torch.tensor([1]), lin.weight)
        y1 = lin(x)
        r1 = x + y1
    assert e1.dtype == torch.float32 and y1.dtype == torch.bfloat16
    assert r1.dtype == torch.float32           # f32 + bf16 promotes


def test_unported_options_raise():
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    opt = AdamW(learning_rate=1e-4)
    with pytest.raises(NotImplementedError, match="GradScaler"):
        TrainStep(m, lambda o, y: o.sum(), opt, scaler=object())
    with pytest.raises(NotImplementedError, match="donation"):
        TrainStep(m, lambda o, y: o.sum(), opt, donate=True)
    md = GPTForCausalLM(gpt_tiny(dropout=0.1), device="cpu")
    ids = torch.from_numpy(_ids())
    with pytest.raises(NotImplementedError, match="dropout"):
        md(ids)
    md.eval()
    assert md(ids).shape == (2, SEQ, 256)
