"""Gradient clipping: the port of ``paddle_tpu/nn/clip.py``, with the
semantics of the compiled step's functional clip
(``paddle_tpu/jit/train_step.py:65-84``).

Each clip is called with ``[(param, grad), ...]`` and returns the pairs
with clipped grads; parameters whose ``need_clip`` attribute is False keep
theirs. Nothing reads the device back: the factors stay tensors.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


def _clipped(params_grads):
    return [g is not None and getattr(p, "need_clip", True)
            for p, g in params_grads]


class ClipGradByValue:
    """Clamp every grad to ``[min, max]`` (``min`` defaults to -max)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if c else g)
                for (p, g), c in zip(params_grads, _clipped(params_grads))]


class ClipGradByNorm:
    """Scale each grad whose 2-norm exceeds ``clip_norm`` down to it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for (p, g), c in zip(params_grads, _clipped(params_grads)):
            if c:
                n = g.square().sum().sqrt()
                g = torch.where(n > self.clip_norm, g * (self.clip_norm / n),
                                g)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """Scale every grad by ``clip_norm / max(global_norm, 1e-12)`` when the
    global 2-norm (over all clipped grads, in float32) exceeds
    ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        mask = _clipped(params_grads)
        grads = [g for (_, g), c in zip(params_grads, mask) if c]
        if not grads:
            return params_grads
        gn = torch.stack([g.float().square().sum() for g in grads]).sum() \
            .sqrt()
        factor = torch.where(gn > self.clip_norm,
                             self.clip_norm / gn.clamp(min=1e-12),
                             torch.ones_like(gn))
        return [(p, g * factor.to(g.dtype) if c else g)
                for (p, g), c in zip(params_grads, mask)]
