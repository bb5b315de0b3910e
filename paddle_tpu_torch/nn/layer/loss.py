"""``CrossEntropyLoss``: the port of ``paddle_tpu/nn/layer/loss.py``'s; the
other loss layers wait for ROADMAP queue 1 item 5d, part 2."""
from __future__ import annotations

from ..functional.loss import cross_entropy
from .layers import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return cross_entropy(input, label, self.weight, self.ignore_index,
                             self.reduction, self.soft_label, self.axis,
                             self.use_softmax, self.label_smoothing)
