"""The regularizers of the port (``paddle.regularizer.L1Decay``/``L2Decay``)
through ``ParamAttr(regularizer=)`` and through the optimizers'
``weight_decay``, with the reference's precedence (the parameter's own
regularizer, then the optimizer's object, then a float ``weight_decay``),
held against the JAX package over two steps of SGD, Momentum, Adam and
AdamW from the same weights: parameters within 1e-5 relative and 1e-6
absolute (both refused before)."""
import numpy as np
import pytest

from torch_nn_parity import both, carry_state, rand

X = rand(4, 6, seed=1)


def _net(P, param_reg, bias_reg):
    nn = P.nn
    return nn.Sequential(
        nn.Linear(6, 5, weight_attr=P.ParamAttr(regularizer=param_reg)),
        nn.Tanh(),
        nn.Linear(5, 3, bias_attr=P.ParamAttr(regularizer=bias_reg)))


def _reg(P, spec):
    if spec is None:
        return None
    kind, coeff = spec
    return getattr(P.regularizer, kind)(coeff)


OPTS = {
    "sgd": lambda P, params, wd: P.optimizer.SGD(0.1, parameters=params,
                                                 weight_decay=wd),
    "momentum": lambda P, params, wd: P.optimizer.Momentum(
        0.1, 0.9, parameters=params, weight_decay=wd),
    "adam": lambda P, params, wd: P.optimizer.Adam(0.01, parameters=params,
                                                   weight_decay=wd),
    "adamw": lambda P, params, wd: P.optimizer.AdamW(
        0.01, parameters=params, weight_decay=wd),
}
CASES = [
    ("sgd", ("L2Decay", 0.1), None, None),
    ("sgd", ("L1Decay", 0.05), ("L2Decay", 0.2), 0.01),
    ("sgd", None, None, ("L1Decay", 0.3)),
    ("momentum", ("L2Decay", 0.5), None, ("L1Decay", 0.1)),
    ("momentum", None, None, 0.2),
    ("adam", ("L1Decay", 0.1), ("L2Decay", 0.1), ("L2Decay", 0.05)),
    ("adamw", ("L2Decay", 0.1), None, 0.05),
    ("adamw", None, ("L1Decay", 0.2), ("L2Decay", 0.3)),
]


@pytest.mark.parametrize("opt,param_reg,bias_reg,wd", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_regularized_steps_match_jax(opt, param_reg, bias_reg, wd):
    jp, tp = both()
    nets = {P: _net(P, _reg(P, param_reg), _reg(P, bias_reg))
            for P in (jp, tp)}
    carry_state(nets[jp], nets[tp])
    params = {}
    for P, net in nets.items():
        o = OPTS[opt](P, net.parameters(),
                      _reg(P, wd) if isinstance(wd, tuple) else wd)
        for _ in range(2):
            y = net(P.to_tensor(X))
            (y * y).sum().backward()
            o.step()
            o.clear_grad()
        params[P] = {k: v.numpy() for k, v in net.state_dict().items()}
    for k in params[jp]:
        np.testing.assert_allclose(params[tp][k], params[jp][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_regularizer_objects_and_precedence():
    """``L2Decay`` adds ``c · p`` to the gradient, ``L1Decay`` ``c ·
    sign(p)``; a parameter's regularizer replaces the optimizer's (the
    reference's precedence), so one SGD step from zero gradients moves each
    parameter by its own term only."""
    _, tp = both()
    p = tp.create_parameter([3], "float32")
    p.set_value(np.array([1.0, -2.0, 0.0], np.float32))
    q = tp.create_parameter([3], "float32")
    q.set_value(np.array([1.0, -2.0, 0.0], np.float32))
    p.regularizer = tp.L1Decay(0.5)
    opt = tp.optimizer.SGD(1.0, parameters=[p, q],
                           weight_decay=tp.L2Decay(0.25))
    opt.apply_gradients([(p, tp.zeros([3])), (q, tp.zeros([3]))])
    np.testing.assert_allclose(p.numpy(), [0.5, -1.5, 0.0])
    np.testing.assert_allclose(q.numpy(), [0.75, -1.5, 0.0])
    g = tp.to_tensor(np.ones(3, np.float32))
    np.testing.assert_allclose(
        tp.L2Decay(2.0).apply(g._data, q._data.detach()).numpy(),
        [2.5, -2.0, 1.0])
    assert repr(tp.L1Decay(0.5)) == "L1Decay(0.5)"
    assert tp.ParamAttr(regularizer=tp.L2Decay(1.0)).regularizer.coeff == 1.0
