"""The six optimizers the port added to ``paddle.optimizer`` (LarsMomentum,
Adagrad, Adadelta, Adamax, RMSProp centered and with momentum, Lamb)
against the JAX package's: three steps of a small net from the same weights
and inputs, parameters within rtol 2e-4 / atol 2e-5 (the steps' limits of
``__graft_entry__._assert_matches_single``); a GradScaler skip that leaves
parameters and accumulators bit for bit; a regularizer; LARS's exclusion by
name; LAMB's exclusion function; and a JAX optimizer's state carried in by
``convert.load_jax_optimizer_state``, then one more step equal."""
import numpy as np
import pytest

from torch_nn_parity import both, carry_state, rand

RTOL, ATOL = 2e-4, 2e-5
X = rand(8, 6, seed=3)


def _net(P, names=False):
    nn = P.nn

    def attr(n):
        return P.ParamAttr(name=n) if names else None
    return nn.Sequential(
        nn.Linear(6, 5, weight_attr=attr("fc1.w_0"), bias_attr=attr("fc1.b_0")),
        nn.Tanh(),
        nn.LayerNorm(5, weight_attr=attr("ln.w_0"), bias_attr=attr("ln.b_0")),
        nn.Linear(5, 3, weight_attr=attr("fc2.w_0"), bias_attr=attr("fc2.b_0")))


def _one_d(p):
    return len(p.shape) == 1      # biases and the norm's scale and shift


OPTS = {
    "lars": lambda O, ps: O.LarsMomentum(0.1, 0.9, lars_coeff=0.01,
                                         lars_weight_decay=0.01,
                                         parameters=ps),
    "lars_optimizer": lambda O, ps: O.LarsMomentumOptimizer(
        0.05, 0.8, parameters=ps, epsilon=1e-6, rescale_grad=0.5),
    "adagrad": lambda O, ps: O.Adagrad(0.1, parameters=ps),
    "adadelta": lambda O, ps: O.Adadelta(1.0, rho=0.9, parameters=ps),
    "adamax": lambda O, ps: O.Adamax(0.02, parameters=ps),
    "rmsprop": lambda O, ps: O.RMSProp(0.01, parameters=ps),
    "rmsprop_centered_momentum": lambda O, ps: O.RMSProp(
        0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps),
    "lamb": lambda O, ps: O.Lamb(0.01, lamb_weight_decay=0.05,
                                 parameters=ps),
}


def _steps(P, net, opt, n):
    for _ in range(n):
        y = net(P.to_tensor(X))
        (y * y).sum().backward()
        opt.step()
        opt.clear_grad()
    return {k: v.numpy() for k, v in net.state_dict().items()}


def _run_both(make, steps=3, names=False):
    jp, tp = both()
    nets = {P: _net(P, names) for P in (jp, tp)}
    carry_state(nets[jp], nets[tp])
    out = {}
    for P, net in nets.items():
        opt = make(P.optimizer, net.parameters())
        out[P] = _steps(P, net, opt, steps)
    return out[tp], out[jp]


def _assert_params(got, want, tag):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_three_steps_match_jax(kind):
    got, want = _run_both(OPTS[kind])
    _assert_params(got, want, kind)


def test_gradscaler_skip_leaves_state_bit_for_bit():
    """After a step that made the accumulators, an overflowed gradient: the
    eager ``GradScaler.step`` and the device-side skip of ``_apply`` (a
    True ``found_inf``, as TrainStep passes it) each leave every parameter
    and accumulator exactly as it was, for each optimizer."""
    import torch
    _, tp = both()
    for kind, make in OPTS.items():
        tp.seed(0)
        net = _net(tp)
        opt = make(tp.optimizer, net.parameters())
        _steps(tp, net, opt, 1)
        before = [t.clone() for t in opt._parameters] + [
            t.clone() for store in opt._accumulators.values()
            for t in store.values()]
        scaler = tp.amp.GradScaler(init_loss_scaling=2.0 ** 4)
        y = net(tp.to_tensor(X))
        scaler.scale((y * y).sum()).backward()
        net[0].weight.grad._data[0, 0] = float("inf")
        scaler.step(opt)
        grads = [(p, p.grad) for p in opt._parameters]
        opt._apply(grads, 0.1, 2, skip=torch.tensor(True))
        after = list(opt._parameters) + [
            t for store in opt._accumulators.values() for t in store.values()]
        assert len(after) == len(before) > len(opt._parameters), kind
        for a, b in zip(after, before):
            assert torch.equal(a, b), kind


def test_regularizer_through_lamb_and_adagrad():
    """A parameter's L2Decay and the optimizer's L1Decay object (the
    reference's precedence) through two of the new rules."""
    for make in (lambda O, ps: O.Adagrad(0.1, parameters=ps,
                                         weight_decay=None),
                 lambda O, ps: O.Lamb(0.01, parameters=ps)):
        jp, tp = both()
        nets = {}
        for P in (jp, tp):
            nn = P.nn
            nets[P] = nn.Sequential(
                nn.Linear(6, 5, weight_attr=P.ParamAttr(
                    regularizer=P.L2Decay(0.3))),
                nn.Tanh(), nn.Linear(5, 3, bias_attr=P.ParamAttr(
                    regularizer=P.L1Decay(0.2))))
        carry_state(nets[jp], nets[tp])
        out = {P: _steps(P, net, make(P.optimizer, net.parameters()), 3)
               for P, net in nets.items()}
        _assert_params(out[tp], out[jp], "regularized")


def test_lars_excludes_weight_decay_by_name():
    """``exclude_from_weight_decay`` by a part of the parameter's name (the
    biases, ``*.b_0``): equal to the reference, and different from the run
    without the exclusion."""
    def make(exclude):
        return lambda O, ps: O.LarsMomentum(
            0.1, 0.9, lars_coeff=0.02, lars_weight_decay=0.2,
            parameters=ps, exclude_from_weight_decay=exclude)
    got, want = _run_both(make([".b_"]), names=True)
    _assert_params(got, want, "lars exclude")
    plain, _ = _run_both(make(None), names=True)
    assert not np.allclose(plain["0.bias"], got["0.bias"])


def test_lamb_exclude_fn():
    """``exclude_from_weight_decay_fn`` called with each parameter: the
    one-dimensional ones (biases, norms) take no decay."""
    def make(fn):
        return lambda O, ps: O.Lamb(0.01, lamb_weight_decay=0.3,
                                    parameters=ps,
                                    exclude_from_weight_decay_fn=fn)
    got, want = _run_both(make(_one_d))
    _assert_params(got, want, "lamb exclude_fn")
    plain, _ = _run_both(make(None))
    assert not np.allclose(plain["0.bias"], got["0.bias"])


@pytest.mark.parametrize("kind", ["lamb", "rmsprop_centered_momentum"])
def test_jax_optimizer_state_carries_in(kind):
    """Two steps in the JAX package; its weights and accumulators (by the
    reference's names) and step count go across through convert.py; one
    more step in both packages agrees."""
    from paddle_tpu_torch import convert
    jp, tp = both()
    jnet, tnet = _net(jp), _net(tp)
    jopt = OPTS[kind](jp.optimizer, jnet.parameters())
    _steps(jp, jnet, jopt, 2)
    carry_state(jnet, tnet)
    topt = OPTS[kind](tp.optimizer, tnet.parameters())
    state = {f"{n}_{an}": np.asarray(jopt._accumulators[an][id(p)])
             for n, p in jnet.named_parameters() for an in jopt._accum_names}
    convert.load_jax_optimizer_state(topt, tnet, state, jopt._step_count)
    assert topt._step_count == 2
    got, want = _steps(tp, tnet, topt, 1), _steps(jp, jnet, jopt, 1)
    _assert_params(got, want, f"{kind} carried")
