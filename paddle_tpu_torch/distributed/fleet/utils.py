"""``recompute``: the port of ``paddle_tpu/distributed/fleet/utils/
__init__.py::recompute`` (``:118-184``).

The reference wraps the segment in ``jax.checkpoint`` inside a traced step:
its activations are dropped after the forward and the segment runs again in
the backward, with the same random keys, so a dropout mask recomputed is
the mask the forward drew. Here it is a non-reentrant
``torch.utils.checkpoint``. The port's dropout draws from its own generator
(``framework/random.py``), which ``checkpoint``'s ``preserve_rng_state``
does not see (it saves torch's global streams only). So the segment's first
run records the port generator's state of every device it may draw on, and
the recompute runs from that state and then puts the generator back where
the rest of the step left it: the recomputed masks are the forward's, and
the stream after the step is the same as without recompute. With grad off
(eval, serving) the segment just runs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...framework import random as random_mod

__all__ = ["recompute"]


def _states(gen, devices) -> dict:
    return {d: gen.for_device(d).get_state() for d in devices}


def _restore(gen, states: dict) -> None:
    for d, st in states.items():
        gen.for_device(d).set_state(st)


def recompute(function, *args, preserve_rng_state=True, use_reentrant=False,
              **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs for the
    backward, where it runs again. ``use_reentrant=True`` is not ported
    (the reference ignores it too inside a traced step)."""
    if use_reentrant:
        raise NotImplementedError(
            "recompute(use_reentrant=True) is not ported: the port's "
            "recompute is non-reentrant")
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    if not preserve_rng_state:
        return checkpoint(function, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    gen = random_mod.default_generator()
    devices = sorted({str(a.device) for a in list(args) + list(
        kwargs.values()) if isinstance(a, torch.Tensor)})
    saved = []

    def segment(*a, **kw):
        if not saved:
            saved.append(_states(gen, devices))
            return function(*a, **kw)
        after = _states(gen, devices)
        _restore(gen, saved[0])
        try:
            return function(*a, **kw)
        finally:
            _restore(gen, after)

    return checkpoint(segment, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)
