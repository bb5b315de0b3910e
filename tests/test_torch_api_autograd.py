"""Autograd of the Paddle API (``core/autograd.py``, over torch's) against
the JAX package's tape on the same numpy inputs: ``backward`` with a
``grad_tensor``, ``retain_graph`` and accumulation; ``paddle.grad`` with
``create_graph`` (second order), ``allow_unused`` and ``no_grad``;
``stop_gradient`` on a leaf and on a result; hooks; ``clear_grad``; the
in-place rule on a leaf; ``FLAGS_check_nan_inf``."""
import numpy as np
import pytest

X = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
W = np.random.RandomState(1).uniform(-1, 1, (3, 4)).astype(np.float32)


def _both():
    import paddle_tpu
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu, paddle_tpu_torch


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _each(fn):
    """``fn(P)`` in both packages; returns (port's, reference's)."""
    jp, tp = _both()
    return fn(tp), fn(jp)


def test_backward_grad_tensor_retain_and_accumulate():
    def run(P):
        x = P.to_tensor(X, stop_gradient=False)
        y = P.tanh(x) * x
        y.backward(P.to_tensor(W), retain_graph=True)
        first = x.grad.numpy()
        y.sum().backward()
        return first, x.grad.numpy()
    (pf, pa), (rf, ra) = _each(run)
    _close(pf, rf)
    _close(pa, ra)


def test_second_order_grad_with_create_graph():
    def run(P):
        x = P.to_tensor(X, stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = P.grad(y, x, create_graph=True)
        (gg,) = P.grad(g.sum(), x)
        return g.numpy(), gg.numpy()
    (pg, pgg), (rg, rgg) = _each(run)
    _close(pg, rg)
    _close(pgg, rgg)
    _close(pgg, 6 * X)


def test_grad_allow_unused_and_unused_raises():
    jp, tp = _both()
    for P in (tp, jp):
        x = P.to_tensor(X, stop_gradient=False)
        z = P.to_tensor(W, stop_gradient=False)
        y = (x * 2).sum()
        gx, gz = P.grad(y, [x, z], retain_graph=True, allow_unused=True)
        assert gz is None
        _close(gx.numpy(), np.full_like(X, 2))
        with pytest.raises(RuntimeError, match="not have been used"):
            P.grad(y, [x, z])
        assert x.grad is None      # paddle.grad leaves .grad alone


def test_no_grad_and_stop_gradient():
    def run(P):
        x = P.to_tensor(X, stop_gradient=False)
        with P.no_grad():
            y = x * 2
        held = y.stop_gradient

        @P.no_grad()
        def f(t):
            return t * 3
        z = f(x)
        c = P.to_tensor(W)                # stop_gradient=True by default
        r = c * 2                         # a result of a stopped input
        loss = (r * x).sum()
        loss.backward()
        return (held, z.stop_gradient, c.stop_gradient, r.stop_gradient,
                loss.stop_gradient, x.grad.numpy(), c.grad)
    port, ref = _each(run)
    assert port[:5] == ref[:5] == (True, True, True, True, False)
    _close(port[5], ref[5])
    _close(port[5], 2 * W)
    assert port[6] is None and ref[6] is None


def test_stop_gradient_on_a_result_cuts_the_graph():
    """Setting ``stop_gradient=True`` on a computed tensor stops the
    gradient there, as Paddle's eager mode does (the port: the result is
    detached)."""
    _, tp = _both()
    x = tp.to_tensor(X, stop_gradient=False)
    c = x * 2
    c.stop_gradient = True
    (c * x).sum().backward()
    _close(x.grad.numpy(), 2 * X)


def test_hooks_and_clear_grad():
    def run(P):
        x = P.to_tensor(X, stop_gradient=False)
        seen = []

        def hook(g):
            seen.append(g.numpy())
            return g * 10
        h = x.register_hook(hook)
        (x * P.to_tensor(W)).sum().backward()
        got = x.grad.numpy()
        h.remove()
        x.clear_grad()
        cleared = x.grad is None
        (x * P.to_tensor(W)).sum().backward()
        return seen[0], got, cleared, x.grad.numpy()
    port, ref = _each(run)
    _close(port[0], ref[0])
    _close(port[1], ref[1])
    _close(port[1], 10 * W)
    assert port[2] and ref[2]
    _close(port[3], ref[3])


def test_in_place_on_a_leaf_keeps_its_gradient():
    def run(P):
        x = P.to_tensor(X, stop_gradient=False)
        x.scale_(2.0)
        x.exp_()
        x.sum().backward()
        return x.numpy(), x.grad.numpy(), x.stop_gradient
    port, ref = _each(run)
    _close(port[0], ref[0])
    _close(port[1], ref[1])
    assert port[2] is False and ref[2] is False


def test_check_nan_inf_flag():
    jp, tp = _both()
    for P in (tp, jp):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError,
                               match="Operator log output contains NaN"):
                P.log(P.to_tensor(np.array([-1.0], np.float32)))
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
        assert not P.get_flags(["FLAGS_check_nan_inf"])[
            "FLAGS_check_nan_inf"]


def test_saved_tensors_hooks_pack_and_unpack():
    from paddle_tpu_torch.core.autograd import saved_tensors_hooks
    _, tp = _both()
    packed = []
    x = tp.to_tensor(X, stop_gradient=False)
    with saved_tensors_hooks(lambda t: packed.append(t.numpy()) or t,
                             lambda t: t):
        y = (tp.exp(x)).sum()
    y.backward()
    assert packed
    _close(x.grad.numpy(), np.exp(X))


def test_set_grad_enabled_and_is_grad_enabled():
    _, tp = _both()
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
        y = tp.to_tensor(X, stop_gradient=False) * 2
    assert tp.is_grad_enabled() and y.stop_gradient
    with tp.no_grad():
        with tp.enable_grad():
            z = tp.to_tensor(X, stop_gradient=False) * 2
    assert not z.stop_gradient
