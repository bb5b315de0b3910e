"""Weight regularizers: the port of ``paddle_tpu/regularizer.py``.

A regularizer adds its term to a parameter's gradient before the update
(``paddle_tpu/optimizer/optimizer.py:130-139``): ``L2Decay(c)`` adds
``c · p``, ``L1Decay(c)`` adds ``c · sign(p)``. A parameter takes one through
``ParamAttr(regularizer=)``, an optimizer through ``weight_decay=``; the
parameter's wins. The optimizers apply :meth:`WeightDecayRegularizer.apply_`
to a whole group of gradients at once (``torch._foreach_*``).
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def apply(self, grad, param):
        """The regularized gradient of one parameter."""
        return self.apply_([grad], [param])[0]

    def apply_(self, grads, params):
        """The regularized gradients of a list of parameters (new tensors,
        each in its gradient's type)."""
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def apply_(self, grads, params):
        return torch._foreach_add(grads, params, alpha=self.coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay(WeightDecayRegularizer):
    def apply_(self, grads, params):
        return torch._foreach_add(grads, torch._foreach_sign(params),
                                  alpha=self.coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"
