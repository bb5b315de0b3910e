"""Optimizers: the port of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``SGD``, ``Momentum``, ``LarsMomentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``Adadelta``, ``Adamax``, ``RMSProp``, ``Lamb``).

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

LAMB's and LARS's trust ratios are per tensor: ``torch._foreach_norm`` of
each group's parameters and updates, the ratios and the reference's guards
for a zero norm computed on the device, so no step waits for the host.
Every optimizer keeps the reference's accumulator names (``_accum_names``),
so ``convert.load_jax_optimizer_state`` carries its state across.

Step observers (``register_step_observer``, as the reference's): each is
called as ``fn(optimizer, duration_s, n_params)`` after every update, by
``step()``/``apply_gradients`` and by ``jit.TrainStep``'s update.
``duration_s`` is the host's wall time of the update call, as in the
reference; on a GPU that is the time to enqueue the update's kernels, not
the device's time. With no observer registered nothing is timed.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..core.tensor import Tensor
from .lr import LRScheduler

__all__ = ["register_step_observer", "unregister_step_observer",
           "Optimizer", "SGD", "Momentum", "LarsMomentum",
           "LarsMomentumOptimizer", "Adam", "AdamW", "Adagrad", "Adadelta",
           "Adamax", "RMSProp", "Lamb"]

# elements per group of parameters updated together: bounds the float32
# working copies a bf16-moment update makes (4 copies of 32 M floats)
_CHUNK_ELEMS = 32 * 1024 * 1024

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# Step observers: ``fn(optimizer, duration_s, n_params)`` after every
# update. The observability layer registers here
# (training.instrument_optimizers).
_step_observers: List = []


def register_step_observer(fn):
    if fn not in _step_observers:
        _step_observers.append(fn)
    return fn


def unregister_step_observer(fn):
    if fn in _step_observers:
        _step_observers.remove(fn)


def notify_step_observers(optimizer, t0, n_params) -> None:
    """Call every observer with the wall time since ``t0`` (a
    ``time.perf_counter()`` reading; None when no observer was registered
    at the update's start). An observer's failure never fails the
    update."""
    if t0 is None:
        return
    dt = time.perf_counter() - t0
    for fn in list(_step_observers):
        try:
            fn(optimizer, dt, n_params)
        except Exception:  # noqa: BLE001 - telemetry must never fail
            pass           # the update it observes


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x`` (the
    reference's scalars are float32 arrays)."""
    return float(np.float32(x))


def _bias_correction(beta, t) -> float:
    """1 - beta^t in float32, as the reference computes it."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(t))


def _trust(num, den, ok_num, ok_den, fallback):
    """Per tensor, ``num / den`` where both norms ``ok_num`` and ``ok_den``
    are above zero, else ``fallback`` (the reference's guard for a fresh
    or frozen tensor): lists of 0-d tensors in, a list of 0-d tensors out,
    all on the device."""
    a, b = torch.stack(ok_num), torch.stack(ok_den)
    ratio = torch.where((a > 0) & (b > 0), torch.stack(num) / torch.stack(
        den), torch.as_tensor(fallback, dtype=a.dtype, device=a.device))
    return list(ratio.unbind())


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
        count, update, and call the step observers."""
        t0 = time.perf_counter() if _step_observers else None
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        self._apply(params_grads, lr, self._step_count)
        notify_step_observers(self, t0, len(params_grads))

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


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling (``paddle_tpu/optimizer/
    optimizer.py:266``): per tensor, local_lr = lr · lars_coeff · ‖p‖ /
    (‖g‖ + wd · ‖p‖ + eps), or lr where either norm is zero; v = μ v +
    local_lr · (g + wd · p); p −= v. ``wd`` is ``lars_weight_decay``, 0 for
    a parameter whose name holds one of ``exclude_from_weight_decay``."""

    _accum_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._exclude = list(exclude_from_weight_decay or [])
        self._eps = epsilon
        self._rescale = rescale_grad

    def _wd_for(self, p) -> float:
        if any(tag in self._name(p) for tag in self._exclude):
            return 0.0
        return self._lars_wd

    def _update_rule(self, ps, gs, lr, t, wd, state):
        if self._rescale != 1.0:
            gs = torch._foreach_mul(gs, self._rescale)
        p_norm = torch._foreach_norm(ps)
        g_norm = torch._foreach_norm(gs)
        den = torch._foreach_add(torch._foreach_mul(p_norm, wd), g_norm)
        torch._foreach_add_(den, self._eps)
        num = torch._foreach_mul(p_norm, _f32(lr * self._coeff))
        local_lr = _trust(num, den, p_norm, g_norm, lr)
        upd = torch._foreach_add(gs, ps, alpha=wd) if wd else list(gs)
        torch._foreach_mul_(upd, local_lr)
        vs = state["velocity"]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, upd)
        torch._foreach_sub_(ps, vs)


LarsMomentumOptimizer = LarsMomentum


class Adagrad(Optimizer):
    """``moment += g²``; p −= lr · g / (√moment + eps) (``:393``). The
    moments start at ``initial_accumulator_value``."""

    _accum_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_val = initial_accumulator_value

    def _get_accum(self, name, p):
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.full(p.shape, self._init_val,
                                      dtype=p.dtype, device=p.device)
        return store[id(p)]

    def _update_rule(self, ps, gs, lr, t, wd, state):
        mom = state["moment"]
        torch._foreach_addcmul_(mom, gs, gs)
        denom = torch._foreach_sqrt(mom)
        torch._foreach_add_(denom, self._eps)
        torch._foreach_addcdiv_(ps, gs, denom, value=-lr)


class Adadelta(Optimizer):
    """E[g²] = ρ E[g²] + (1 − ρ) g²; u = g √(E[u²] + eps) / √(E[g²] + eps);
    E[u²] = ρ E[u²] + (1 − ρ) u²; p −= lr · u (``:409``)."""

    _accum_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._rho = rho

    def _update_rule(self, ps, gs, lr, t, wd, state):
        sg, su = state["avg_squared_grad"], state["avg_squared_update"]
        torch._foreach_mul_(sg, self._rho)
        torch._foreach_addcmul_(sg, gs, gs, value=1 - self._rho)
        num = torch._foreach_add(su, self._eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(sg, self._eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_mul(gs, num)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(su, self._rho)
        torch._foreach_addcmul_(su, upd, upd, value=1 - self._rho)
        torch._foreach_add_(ps, upd, alpha=-lr)


class Adamax(Optimizer):
    """m = β₁ m + (1 − β₁) g; u = max(β₂ u, |g|); p −= lr / (1 − β₁ᵗ) · m /
    (u + eps) (``:427``)."""

    _accum_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_rule(self, ps, gs, lr, t, wd, state):
        ms, us = state["moment"], state["inf_norm"]
        torch._foreach_mul_(ms, self._beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self._beta1)
        torch._foreach_mul_(us, self._beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, self._eps)
        lr_t = _f32(np.float32(lr) / np.float32(
            _bias_correction(self._beta1, t)))
        torch._foreach_addcdiv_(ps, ms, denom, value=-lr_t)


class RMSProp(Optimizer):
    """E[g²] = ρ E[g²] + (1 − ρ) g²; centered, E[g] = ρ E[g] + (1 − ρ) g and
    the denominator √(E[g²] − E[g]² + eps), else √(E[g²] + eps); mom = μ mom
    + lr · g / denominator; p −= mom (``:445``)."""

    _accum_names = ["mean_square", "mean_grad", "momentum_acc"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_rule(self, ps, gs, lr, t, wd, state):
        ms, mg = state["mean_square"], state["mean_grad"]
        mom = state["momentum_acc"]
        torch._foreach_mul_(ms, self._rho)
        torch._foreach_addcmul_(ms, gs, gs, value=1 - self._rho)
        if self._centered:
            torch._foreach_mul_(mg, self._rho)
            torch._foreach_add_(mg, gs, alpha=1 - self._rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1)
        else:
            denom = [x.clone() for x in ms]
        torch._foreach_add_(denom, self._eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_addcdiv_(mom, torch._foreach_mul(gs, lr), denom)
        torch._foreach_sub_(ps, mom)


class Lamb(Optimizer):
    """LAMB (``:470``): Adam's moments and bias corrections, r = m̂ / (√v̂ +
    eps) + wd · p, and per tensor p −= lr · trust · r with trust = ‖p‖ / ‖r‖
    (1 where either norm is zero). ``wd`` is ``lamb_weight_decay``, 0 for a
    parameter that ``exclude_from_weight_decay_fn`` (called with the Paddle
    parameter, as the reference calls it) returns True for."""

    _accum_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _wd_for(self, p) -> float:
        if self._exclude_fn is not None and self._exclude_fn(
                getattr(p, "_paddle", p)):
            return 0.0
        return self._lamb_wd

    def _update_rule(self, ps, gs, lr, t, wd, state):
        ms, vs = state["moment1"], state["moment2"]
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        r = torch._foreach_div(ms, _bias_correction(b1, t))       # m_hat
        denom = torch._foreach_div(vs, _bias_correction(b2, t))   # v_hat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        torch._foreach_div_(r, denom)
        if wd:
            torch._foreach_add_(r, ps, alpha=wd)
        w_norm = torch._foreach_norm(ps)
        r_norm = torch._foreach_norm(r)
        trust = _trust(w_norm, r_norm, w_norm, r_norm, 1.0)
        torch._foreach_mul_(r, torch._foreach_mul(trust, lr))
        torch._foreach_sub_(ps, r)
