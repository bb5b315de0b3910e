"""Optimizers: the port of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``SGD``, ``Momentum``, ``Adam``, ``AdamW``).

The reference's update rules, exactly (``optimizer.py:330-390``): Adam's
bias corrections computed in float32, eps outside √v̂, AdamW's decoupled
decay ``p·(1 − lr·wd)`` applied to every parameter unless
``apply_decay_param_fun`` says otherwise, and ``moment_dtype`` ("bfloat16"
moments for float32 parameters) with the update maths in float32 either
way. ``torch.optim.AdamW`` cannot keep bf16 moments for float32 parameters,
so the rules are written here as ``torch._foreach_*`` ops over lists of
tensors, updating the parameters and their accumulators in place.
Accumulators live on their parameter's device.

A parameter's name (for ``apply_decay_param_fun`` and ``state_dict``) is
the Paddle :class:`core.tensor.Parameter`'s ``name``, as in the reference,
when ``parameters=`` holds Paddle parameters (``Layer.parameters()``);
torch tensors carry no name of their own, so for them it is their key in
the model's ``named_parameters()`` (``(name, tensor)`` pairs; ``TrainStep``
names the model's parameters). A Paddle parameter's ``optimize_attr``
learning-rate factor (``ParamAttr(learning_rate=)``) scales its step, and
its ``regularizer`` (``ParamAttr(regularizer=)``) adds to its gradient
before the update, ahead of the optimizer's ``weight_decay`` (a float, or
an ``L1Decay``/``L2Decay`` object; AdamW takes either as its decoupled
coefficient), as the reference. The optimizer updates the torch tensors the
parameters hold, in place.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.tensor import Tensor
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

# elements per group of parameters updated together: bounds the float32
# working copies a bf16-moment update makes (4 copies of 32 M floats)
_CHUNK_ELEMS = 32 * 1024 * 1024

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x`` (the
    reference's scalars are float32 arrays)."""
    return float(np.float32(x))


class Optimizer:
    _accum_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._grad_clip = grad_clip
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._l2_coeff = float(weight_decay or 0.0)
            self._wd_obj = None
        else:                       # an L1Decay / L2Decay object
            self._wd_obj = weight_decay
            self._l2_coeff = float(getattr(weight_decay, "coeff", 0.0))
        self._names: Dict[int, str] = {}
        self._lr_mult: Dict[int, float] = {}
        self._parameters = None
        if parameters is not None:
            self._parameters = []
            for i, item in enumerate(parameters):
                name, p = item if isinstance(item, tuple) else \
                    (f"param_{i}", item)
                if isinstance(p, Tensor):      # a Paddle parameter
                    name = p.name
                    mult = getattr(p, "optimize_attr", {}).get(
                        "learning_rate", 1.0)
                    p = p._data
                    if mult != 1.0:
                        self._lr_mult[id(p)] = float(mult)
                self._parameters.append(p)
                self._names[id(p)] = name
        # accumulator name -> id(param) -> tensor
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0

    # ------------- lr -------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "set_lr cannot be used while the lr is an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # ------------- parameters and accumulators -------------
    def _name(self, p) -> str:
        return self._names.get(id(p), "")

    def _bind(self, named_params) -> None:
        """Name ``(name, param)`` pairs (TrainStep binds the model's)."""
        for name, p in named_params:
            self._names[id(p)] = name

    def _accum_dtype(self, p) -> torch.dtype:
        return p.dtype

    def _get_accum(self, name, p):
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros(p.shape, dtype=self._accum_dtype(p),
                                       device=p.device)
        return store[id(p)]

    def _set_accum(self, name, p, value):
        self._accumulators.setdefault(name, {})[id(p)] = value

    # ------------- the update -------------
    def _decoupled_wd(self) -> bool:
        return False

    def _wd_for(self, p) -> float:
        """Decoupled weight-decay coefficient of ``p`` (AdamW)."""
        return 0.0

    def _regularizer_for(self, p):
        """The regularizer of ``p``'s gradient, the reference's precedence
        (``paddle_tpu/optimizer/optimizer.py:130-139``): the parameter's own
        (``ParamAttr(regularizer=)``), else the optimizer's
        ``weight_decay`` object, else None (a float ``weight_decay`` is
        applied as L2 by :meth:`_apply`, outside AdamW)."""
        own = getattr(getattr(p, "_paddle", None), "regularizer", None)
        return own if own is not None else self._wd_obj

    def _update_rule(self, ps, gs, lr, t, wd, state) -> None:
        """Update the parameters ``ps`` in place from their grads ``gs``
        (each in its parameter's type) and the accumulator lists in
        ``state``; ``lr`` and ``wd`` are float32 values, ``t`` the step
        count."""
        raise NotImplementedError

    @torch.no_grad()
    def _apply(self, params_grads, lr, t, skip=None) -> None:
        """One update at learning rate ``lr`` and step ``t`` (no clipping,
        no step count): grouped by decay coefficient, in groups of at most
        ``_CHUNK_ELEMS`` elements. ``skip``, a 0-d bool tensor (dynamic loss
        scaling's ``found_inf``), leaves the parameters and every
        accumulator exactly as they were where it is True, without a host
        sync: each group's values are kept before its update and selected
        back after it, as the reference's ``where(found_inf, old, new)``."""
        groups: Dict[tuple, list] = {}
        for p, g in params_grads:
            if isinstance(p, Tensor):
                p = p._data
            if isinstance(g, Tensor):
                g = g._data
            if g is not None:
                groups.setdefault((self._wd_for(p), self._lr_mult.get(
                    id(p), 1.0), self._regularizer_for(p)), []).append(
                        (p, g))
        for (wd, mult, reg), pairs in groups.items():
            start = 0
            while start < len(pairs):
                end, n = start, 0
                while end < len(pairs) and (end == start or n + pairs[
                        end][0].numel() <= _CHUNK_ELEMS):
                    n += pairs[end][0].numel()
                    end += 1
                chunk = pairs[start:end]
                start = end
                ps = [p for p, _ in chunk]
                gs = [g if g.dtype == p.dtype else g.to(p.dtype)
                      for p, g in chunk]
                if reg is not None:
                    gs = reg.apply_(gs, ps)
                elif self._l2_coeff and not self._decoupled_wd():
                    gs = torch._foreach_add(gs, ps, alpha=self._l2_coeff)
                state = {an: [self._get_accum(an, p) for p in ps]
                         for an in self._accum_names}
                touched = ps + [x for xs in state.values() for x in xs]
                kept = None if skip is None else [x.clone() for x in touched]
                self._update_rule(ps, gs, _f32(lr * mult), t, _f32(wd),
                                  state)
                if kept is not None:
                    for x, old in zip(touched, kept):
                        torch.where(skip, old, x, out=x)

    def apply_gradients(self, params_grads):
        """Apply explicit ``(param, grad)`` pairs: clip, advance the step
        count, update."""
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        self._apply(params_grads, lr, self._step_count)

    def step(self):
        if self._parameters is None:
            raise ValueError(
                "Optimizer created without parameters; pass parameters=")
        self.apply_gradients([(p, p.grad) for p in self._parameters
                              if p.requires_grad and p.grad is not None])

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters or []:
            p.grad = None

    clear_gradients = clear_grad

    # ------------- state dict -------------
    def state_dict(self):
        """``{f"{param name}_{accumulator}": tensor, "@step": n}`` plus
        ``"LR_Scheduler"`` when the lr is a scheduler."""
        sd = {f"{self._names.get(pid, pid)}_{an}": value
              for an, store in self._accumulators.items()
              for pid, value in store.items()}
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        """Load a :meth:`state_dict` into the optimizer's parameters, each
        accumulator in the type it has in ``state_dict``, on its
        parameter's device."""
        for p in self._parameters or []:
            for an in self._accum_names:
                key = f"{self._name(p)}_{an}"
                if key in state_dict:
                    v = state_dict[key]
                    v = v._data if isinstance(v, Tensor) else v
                    self._set_accum(an, p, torch.as_tensor(v).to(p.device))
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                       LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("@step", self._step_count))

    set_dict = set_state_dict


class SGD(Optimizer):
    _accum_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update_rule(self, ps, gs, lr, t, wd, state):
        torch._foreach_add_(ps, gs, alpha=-lr)


class Momentum(Optimizer):
    _accum_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_rule(self, ps, gs, lr, t, wd, state):
        vs = state["velocity"]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._nesterov:
            step = torch._foreach_add(gs, vs, alpha=self._momentum)
        else:
            step = vs
        torch._foreach_add_(ps, step, alpha=-lr)


class Adam(Optimizer):
    _accum_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32", name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if moment_dtype not in _DTYPES:
            raise ValueError(f"moment_dtype must be one of {sorted(_DTYPES)}"
                             f", got {moment_dtype!r}")
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        # "bfloat16" halves the optimizer state (8 -> 4 bytes a parameter);
        # the update maths still runs in float32
        self._moment_dtype = _DTYPES[moment_dtype]

    def _accum_dtype(self, p):
        return self._moment_dtype

    def _update_rule(self, ps, gs, lr, t, wd, state):
        ms, vs = state["moment1"], state["moment2"]
        m = [x.float() for x in ms]     # the accumulators themselves when
        v = [x.float() for x in vs]     # they are float32
        g = [x.float() for x in gs]
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        tf = np.float32(t)
        bc1 = float(np.float32(1) - np.float32(b1) ** tf)
        bc2 = float(np.float32(1) - np.float32(b2) ** tf)
        upd = torch._foreach_div(m, bc1)                   # m_hat
        denom = torch._foreach_div(v, bc2)                 # v_hat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)      # lr * m_hat / (sqrt(v_hat) + eps)
        p32 = [x.float() for x in ps]
        if self._decoupled_wd():
            torch._foreach_mul_(p32, _f32(np.float32(1) - np.float32(lr)
                                          * np.float32(wd)))
        torch._foreach_sub_(p32, upd)
        for dst, src in ((ps, p32), (ms, m), (vs, v)):
            if any(x.dtype != torch.float32 for x in dst):
                torch._foreach_copy_(dst, src)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 moment_dtype="float32", name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, moment_dtype=moment_dtype)
        # a regularizer object gives its coefficient to the decoupled decay
        self._wd = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_fn = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _wd_for(self, p) -> float:
        if self._apply_decay_fn is not None and \
                not self._apply_decay_fn(self._name(p)):
            return 0.0
        return self._wd
