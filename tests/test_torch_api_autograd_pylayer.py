"""``paddle.autograd`` and ``paddle.incubate.autograd`` of the port against
the JAX package's: a ``PyLayer`` with a saved tensor and a custom backward
(forward and the input gradients), ``vjp``, ``jvp``, ``jacobian`` and
``hessian`` over one and two inputs, the lazy ``Jacobian``/``Hessian``,
the eager ``forward_grad`` over a recorded graph and ``grad``, all in
float32 within rtol 1e-5 / atol 1e-6; and the names that need a static
Program raise ``NotImplementedError``."""
import numpy as np
import pytest

from torch_nn_parity import both, rand

RTOL, ATOL = 1e-5, 1e-6
X = rand(3, 4, seed=11)
Y = rand(3, 4, seed=12)


def _close(got, want, what):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    np.testing.assert_allclose(np.asarray(got.numpy()),
                               np.asarray(want.numpy()), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _scaled_tanh(P):
    class ScaledTanh(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y, scale=2.0):
            out = P.tanh(x) * scale
            ctx.save_for_backward(out, y)
            ctx.extra["scale"] = scale
            return out, out * y

        @staticmethod
        def backward(ctx, d_out, d_prod):
            out, y = ctx.saved_tensor
            scale = ctx.extra["scale"]
            local = scale * (1 - (out / scale) ** 2)
            return (d_out * local + d_prod * y * local, d_prod * out)
    return ScaledTanh


def test_pylayer_forward_backward_matches_jax():
    res = {}
    for P in both():
        x = P.to_tensor(X, stop_gradient=False)
        y = P.to_tensor(Y, stop_gradient=False)
        out, prod = _scaled_tanh(P).apply(x, y, scale=1.5)
        (out.sum() + (prod * prod).sum()).backward()
        assert not out.stop_gradient and not prod.stop_gradient
        res[P] = (out, prod, x.grad, y.grad)
    jp, tp = both()
    _close(res[tp], res[jp], "pylayer")


def _f1(P):
    return lambda x: P.tanh(x) * x


def _f2(P):
    return lambda x, y: (P.sin(x) * y, (x * y).sum(axis=0))


def _s2(P):
    return lambda x, y: (P.tanh(x) * y * y).sum()


CASES = {
    "vjp1": lambda P: P.autograd.vjp(_f1(P), P.to_tensor(X)),
    "vjp2": lambda P: P.autograd.vjp(
        _f2(P), [P.to_tensor(X), P.to_tensor(Y)],
        (P.to_tensor(Y), P.to_tensor(X[0]))),
    "jvp1": lambda P: P.autograd.jvp(_f1(P), P.to_tensor(X),
                                     P.to_tensor(Y)),
    "jvp2": lambda P: P.autograd.jvp(_f2(P),
                                     [P.to_tensor(X), P.to_tensor(Y)]),
    "jacobian1": lambda P: P.autograd.jacobian(_f1(P), P.to_tensor(X[0])),
    "jacobian2": lambda P: P.autograd.jacobian(
        _f2(P), [P.to_tensor(X[0]), P.to_tensor(Y[0])]),
    "hessian1": lambda P: P.autograd.hessian(
        lambda x: (P.tanh(x) * x).sum(), P.to_tensor(X[0])),
    "hessian2": lambda P: P.autograd.hessian(
        _s2(P), [P.to_tensor(X[0]), P.to_tensor(Y[0])]),
    "Jacobian": lambda P: P.incubate.autograd.Jacobian(
        _f1(P), P.to_tensor(X[0]))[:],
    "Hessian": lambda P: P.incubate.autograd.Hessian(
        lambda x: (P.tanh(x) * x).sum(), P.to_tensor(X[0]))[:],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_functional_transforms_match_jax(case):
    jp, tp = both()
    _close(CASES[case](tp), CASES[case](jp), case)


def test_forward_grad_and_grad_match_jax():
    """``forward_grad`` of a recorded computation along a seed, twice
    (the graph stays), then ``grad`` of the same outputs."""
    res = {}
    for P in both():
        x = P.to_tensor(X, stop_gradient=False)
        y = P.to_tensor(Y, stop_gradient=False)
        out = P.tanh(x) * y + x * x
        seed = P.to_tensor(Y * 0.5)
        fg = P.incubate.autograd.forward_grad(out, x, seed)
        fg2 = P.incubate.autograd.forward_grad([out], [x, y])
        g = P.incubate.autograd.grad(out.sum(), [x, y])
        res[P] = (fg, fg2[0], g[0], g[1])
    jp, tp = both()
    _close(res[tp], res[jp], "forward_grad")
    assert tp.incubate.autograd.Jacobian(_f1(tp), tp.to_tensor(X[0])).shape \
        == [4, 4]


def test_static_program_names_raise():
    _, tp = both()
    ia = tp.incubate.autograd
    for name in ("orig2prim", "prim2orig", "to_prim"):
        with pytest.raises(NotImplementedError, match="item 5d"):
            getattr(ia, name)()
    with pytest.raises(NotImplementedError, match="item 5d"):
        tp.enable_static()
    tp.disable_static()
    # ported with the elastic checkpoint manager: building the callback
    # touches nothing until fit starts
    cb = tp.callbacks.ElasticCheckpoint("dir")
    assert cb.manager is None and cb.restored is None
    with pytest.raises(NotImplementedError):
        ia.Jacobian(_f1(tp), tp.to_tensor(X[0]), is_batched=True)
    assert not ia.prim_enabled()
    ia.enable_prim()
    assert ia.prim_enabled()
    ia.disable_prim()
    assert not ia.prim_enabled()
