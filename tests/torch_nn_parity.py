"""Shared harness of the ``test_torch_api_nn_*.py`` files: the same numpy
inputs through a function or layer of the JAX package and of the port,
forward and backward, compared within a stated tolerance.

The backward pass is that of ``Σ out · w`` over every floating output, ``w``
a fixed uniform draw of the output's shape, so each output element's
gradient is exercised with its own weight."""
import numpy as np

RTOL, ATOL = 1e-5, 1e-6


def both():
    import paddle_tpu
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu, paddle_tpu_torch


def rand(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _outputs(out):
    if isinstance(out, (tuple, list)):
        flat = []
        for o in out:
            flat.extend(_outputs(o))
        return flat
    return [] if out is None else [out]


def _backward(P, outs):
    loss = None
    for i, o in enumerate(outs):
        arr = o.numpy()
        if not _floating(arr) or o.stop_gradient:
            continue
        w = P.to_tensor(rand(*arr.shape, seed=100 + i))
        term = (o * w).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()


def run(P, fn, arrays, grad):
    ts = [a if not isinstance(a, np.ndarray) else
          P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    outs = _outputs(fn(P, *ts))
    if grad:
        _backward(P, outs)
    return ([np.asarray(o.numpy()) for o in outs],
            [None if ts[i].grad is None else np.asarray(ts[i].grad.numpy())
             for i in grad])


def assert_close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if _floating(want):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_fn_parity(fn, arrays, grad=(), rtol=RTOL, atol=ATOL):
    """``fn(P, *tensors)`` under both packages: every output and the
    gradient of every input in ``grad``."""
    jp, tp = both()
    (po, pg), (jo, jg) = run(tp, fn, arrays, grad), run(jp, fn, arrays, grad)
    assert len(po) == len(jo)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_close(a, b, rtol, atol, f"output {i}")
    for i, (a, b) in zip(grad, zip(pg, jg)):
        _assert_grads(a, b, rtol, atol, f"grad of input {i}")
    return po


def _assert_grads(a, b, rtol, atol, what):
    """Gradients equal; no gradient (None) equals a gradient of zeros (an
    input the output does not depend on differentiably, such as a label
    only compared)."""
    if a is None or b is None:
        other = b if a is None else a
        assert other is None or not np.any(other), what
        return
    assert_close(a, b, rtol, atol, what)


def carry_state(src, dst):
    """``dst.set_state_dict`` from ``src``'s arrays (the reference's names
    and layouts): nothing missing, nothing unexpected."""
    arrays = {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()}
    missing, unexpected = dst.set_state_dict(arrays)
    assert not missing and not unexpected, (missing, unexpected)


def assert_layer_parity(make, arrays, grad=(0,), call=None, rtol=RTOL,
                        atol=ATOL, train=True):
    """``make(P)`` under both packages, the port's state carried from the
    reference's; ``call(layer, *tensors)`` (default: the layer's forward)
    forward and backward: outputs, input gradients and every parameter's
    gradient by name. Returns the two layers."""
    jp, tp = both()
    jl, tl = make(jp), make(tp)
    assert list(tl.state_dict()) == list(jl.state_dict())
    carry_state(jl, tl)
    for layer in (jl, tl):
        layer.train() if train else layer.eval()
    call = call or (lambda layer, *xs: layer(*xs))
    res = []
    for P, layer in ((tp, tl), (jp, jl)):
        outs, grads = run(P, lambda P, *xs: call(layer, *xs), arrays, grad)
        res.append((outs, grads, {n: None if p.grad is None else
                                  np.asarray(p.grad.numpy())
                                  for n, p in layer.named_parameters()}))
    (po, pg, pp), (jo, jg, jpg) = res
    assert len(po) == len(jo)
    for i, (a, b) in enumerate(zip(po, jo)):
        assert_close(a, b, rtol, atol, f"output {i}")
    for i, (a, b) in zip(grad, zip(pg, jg)):
        _assert_grads(a, b, rtol, atol, f"grad of input {i}")
    assert pp.keys() == jpg.keys()
    for n in jpg:
        _assert_grads(pp[n], jpg[n], rtol, atol, f"grad of {n}")
    return jl, tl
