"""The harness of the op-surface tests (``test_torch_api_math.py``,
``_manipulation.py``, ``_logic_linalg.py``): one case per op of the Paddle
API, run under ``paddle_tpu`` and ``paddle_tpu_torch`` on the same numpy
inputs.

A case holds: forward results equal (float32 rtol 1e-5 / atol 1e-6,
integers and booleans exact, dtypes and shapes equal, each result a
``paddle_tpu_torch.Tensor``); where the op is differentiable,
``paddle.grad`` of a fixed projection of the outputs, at the same
tolerance; the port's Tensor method equal to its function; and, where the
port has the in-place variant ``op_``, that variant equal to its functional
result. The JAX package's side runs under ``jax.jit`` (:func:`_run_ref`).
"""
from __future__ import annotations

import numpy as np
import pytest

RTOL, ATOL = 1e-5, 1e-6


class Case:
    def __init__(self, name, *inputs, call=None, grad=True, tol=None,
                 method=True, inplace=True, cid=None, **attrs):
        self.name = name
        self.inputs = inputs
        self.attrs = attrs
        self.call = call or (lambda P, *ts: getattr(P, name)(*ts, **attrs))
        self.grad = grad
        self.tol = tol or (RTOL, ATOL)
        self.method = method and call is None
        self.inplace = inplace and call is None
        self.id = cid or name

    def __repr__(self):
        return self.id


def ids(cases):
    return [c.id for c in cases]


def rng(seed=0):
    return np.random.RandomState(seed)


def f32(*shape, seed=0, lo=-1.0, hi=1.0):
    return rng(seed).uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, seed=0, lo=0, hi=5):
    return rng(seed).randint(lo, hi, shape).astype(np.int64)


def packages():
    import paddle_tpu
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu, paddle_tpu_torch


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _to_np(P, x):
    if isinstance(x, P.Tensor):
        return x.numpy()
    return np.asarray(x)


def _is_float(a) -> bool:
    return np.asarray(a).dtype.kind in "fc"


def _tensors(P, inputs, grad, traced=False):
    out = []
    for a in inputs:
        if traced and hasattr(a, "aval"):
            out.append(P.Tensor(a, stop_gradient=not (
                grad and np.dtype(a.dtype).kind == "f")))
        elif isinstance(a, np.ndarray):
            out.append(P.to_tensor(a, stop_gradient=not (
                grad and a.dtype.kind == "f")))
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            out.append([P.to_tensor(x, stop_gradient=not (
                grad and x.dtype.kind == "f")) for x in a])
        else:
            out.append(a)
    return out


def _leaves(ts):
    out = []
    for t in ts:
        if isinstance(t, list):
            out.extend(_leaves(t))
        elif hasattr(t, "stop_gradient") and not t.stop_gradient:
            out.append(t)
    return out


def _assert_same(tag, port, ref, JP, TP, tol):
    pf, rf = _flat(port), _flat(ref)
    assert len(pf) == len(rf), (tag, len(pf), len(rf))
    for i, (p, r) in enumerate(zip(pf, rf)):
        if isinstance(r, JP.Tensor):
            assert isinstance(p, TP.Tensor), (tag, i, type(p))
            assert str(p.dtype) == str(r.dtype), (tag, i, p.dtype, r.dtype)
            assert p.shape == r.shape, (tag, i, p.shape, r.shape)
        pa, ra = _to_np(TP, p), _to_np(JP, r)
        if ra.dtype.name == "bfloat16":
            ra = ra.astype(np.float32)
        assert pa.shape == ra.shape, (tag, i, pa.shape, ra.shape)
        if _is_float(ra):
            np.testing.assert_allclose(pa, ra, rtol=tol[0], atol=tol[1],
                                       equal_nan=True, err_msg=f"{tag}[{i}]")
        else:
            np.testing.assert_array_equal(pa, ra, err_msg=f"{tag}[{i}]")


def _projection(shape) -> np.ndarray:
    """Fixed weights in (-1, 1) for the gradient's projection: a function
    of the element's index (no random stream, so a traced run and an eager
    one use the same constants)."""
    n = int(np.prod(shape)) if len(shape) else 1
    return np.cos(np.arange(n) * 2.399 + 0.5).astype(np.float32).reshape(
        shape)


def _run(P, case, traced=False):
    """The case's outputs in package ``P`` and, for a differentiable case,
    ``paddle.grad`` of a fixed projection of its float outputs with
    respect to its float inputs (one run serves both). ``traced``: the
    inputs are JAX tracers, wrapped as they are."""
    ts = _tensors(P, case.inputs, case.grad, traced)
    out = case.call(P, *ts)
    leaves = _leaves(ts)
    total = None
    for o in _flat(out):
        if isinstance(o, P.Tensor) and str(o.dtype).startswith("float") \
                and not o.stop_gradient:
            w = P.to_tensor(_projection(o.shape), dtype=o.dtype)
            term = (o * w).sum()
            total = term if total is None else total + term
    grads = None
    if total is not None and leaves:
        grads = P.grad([total], leaves, allow_unused=True)
    return out, grads


def _run_ref(JP, case):
    """:func:`_run` in the JAX package, traced under ``jax.jit`` (one XLA
    program a case: eager, every primitive of the forward and of the
    pullback compiles on its own); an op that reads its data on the host
    (``unique``, ``nonzero``, ...) runs eagerly instead."""
    import jax
    arrays = [a for a in case.inputs if isinstance(a, np.ndarray)]

    def traced(*xs):
        it = iter(xs)
        inner = Case.__new__(Case)
        inner.__dict__.update(case.__dict__)
        inner.inputs = [next(it) if isinstance(a, np.ndarray) else a
                        for a in case.inputs]
        out, grads = _run(JP, inner, traced=True)
        return ([o._data for o in _flat(out)],
                [None if g is None else g._data for g in grads or []])
    try:
        outs, grads = jax.jit(traced)(*arrays)
    except Exception:  # noqa: BLE001 - host-side ops cannot be traced
        return _run(JP, case)
    return ([JP.Tensor(o) for o in outs],
            None if not grads else [None if g is None else JP.Tensor(g)
                                    for g in grads])


def check(case):
    JP, TP = packages()
    tag = case.id
    ref, gr = _run_ref(JP, case)
    port, gp = _run(TP, case)
    _assert_same(tag, port, ref, JP, TP, case.tol)
    assert (gr is None) == (gp is None), (tag, "grad", gr, gp)
    for i, (a, b) in enumerate(zip(gp or [], gr or [])):
        assert (a is None) == (b is None), (tag, "grad", i)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=case.tol[0], atol=case.tol[1],
                                       err_msg=f"{tag} grad[{i}]")
    ts = _tensors(TP, case.inputs, False)
    if case.method and ts and isinstance(ts[0], TP.Tensor) and \
            callable(getattr(TP.Tensor, case.name, None)):
        m = getattr(ts[0], case.name)(*ts[1:], **case.attrs)
        _assert_same(tag + " method", m, port, TP, TP, (0, 0))
    name_ = case.name + "_"
    if case.inplace and hasattr(TP, name_) and \
            not case.name.endswith("_"):
        # the port's in-place variant against its functional form (which
        # the lines above hold against the JAX package)
        xs = _tensors(TP, case.inputs, False)
        got = getattr(TP, name_)(*xs, **case.attrs)
        assert got is xs[0], (tag, "in-place returns its input")
        _assert_same(tag + " in-place", xs[0], _flat(port)[0], TP, TP,
                     (0, 0))


def parametrize(cases):
    return pytest.mark.parametrize("case", cases, ids=ids(cases))
