"""Random ops: the port of ``paddle_tpu/tensor/random.py``.

Every draw comes from the port's generator (``framework/random.py``): the
``torch.Generator`` of the device the result goes to, inside the default
generator, so ``paddle.seed`` governs these ops as it governs dropout, and
``get_rng_state``/``set_rng_state`` round-trip them. A non-zero ``seed=``
draws from a generator of its own seeded with it. torch's streams are not
JAX's: the same seed gives the same draw within the port, not the
reference's numbers.
"""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op, unwrap
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.device import current_device
from .creation import _shape_list


def _dt(dtype):
    return dtype_mod.to_torch_dtype(dtype) if dtype is not None else \
        dtype_mod.default_float_dtype().torch_dtype


def _gen(device, seed=0):
    if seed:
        return random_mod.Generator(seed).for_device(device)
    return random_mod.default_generator().for_device(device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    dev = current_device()
    lo, hi = float(unwrap(min)), float(unwrap(max))
    t = torch.empty(_shape_list(shape), dtype=_dt(dtype), device=dev)
    return Tensor._wrap(t.uniform_(lo, hi, generator=_gen(dev, seed)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    with torch.no_grad():
        x._data.uniform_(float(min), float(max),
                         generator=_gen(x._data.device, seed))
    return x


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def standard_normal(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor._wrap(torch.randn(_shape_list(shape), dtype=_dt(dtype),
                                    device=dev, generator=_gen(dev)))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype, name)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        def fn(m, s):
            m_t = m if isinstance(m, torch.Tensor) else None
            s_t = s if isinstance(s, torch.Tensor) else None
            ref = m_t if m_t is not None else s_t
            shp = torch.broadcast_shapes(
                m_t.shape if m_t is not None else (),
                s_t.shape if s_t is not None else ())
            dt = torch.promote_types(
                m_t.dtype if m_t is not None else torch.float32,
                s_t.dtype if s_t is not None else torch.float32)
            if not dt.is_floating_point:
                dt = _dt(None)
            return m + s * torch.randn(shp, dtype=dt, device=ref.device,
                                       generator=_gen(ref.device))
        return apply_op("normal", fn, mean, std)
    dev = current_device()
    shp = _shape_list(shape) if shape is not None else []
    return Tensor._wrap(mean + std * torch.randn(
        shp, dtype=_dt(None), device=dev, generator=_gen(dev)))


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        x._data.normal_(mean, std, generator=_gen(x._data.device))
    return x


def randint(low=0, high=None, shape=[1], dtype="int64",  # noqa: B006
            name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return Tensor._wrap(torch.randint(
        int(low), int(high), tuple(_shape_list(shape)),
        dtype=dtype_mod.to_torch_dtype(dtype), device=dev,
        generator=_gen(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.dtype, name)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return Tensor._wrap(torch.randperm(
        int(n), dtype=dtype_mod.to_torch_dtype(dtype), device=dev,
        generator=_gen(dev)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return apply_op("multinomial", lambda p: torch.multinomial(
        p, num_samples, replacement, generator=_gen(p.device)), x)


def bernoulli(x, name=None):
    return apply_op("bernoulli", lambda p: torch.bernoulli(
        p.detach(), generator=_gen(p.device)), x)


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        x._data.bernoulli_(p, generator=_gen(x._data.device))
    return x


def poisson(x, name=None):
    return apply_op("poisson", lambda lam: torch.poisson(
        lam.detach(), generator=_gen(lam.device)), x)


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x._data.exponential_(lam, generator=_gen(x._data.device))
    return x


def rand_like(x, dtype=None, name=None):
    return uniform(x.shape, dtype or x.dtype, 0.0, 1.0)


def randn_like(x, dtype=None, name=None):
    return standard_normal(x.shape, dtype or x.dtype)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    return Tensor._wrap(mean + std * torch.randn(
        _shape_list(shape), dtype=_dt(dtype), device=dev,
        generator=_gen(dev, seed)))
