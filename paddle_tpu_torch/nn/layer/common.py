"""``Dropout`` (the port of ``paddle_tpu/nn/layer/common.py::Dropout``):
``nn.functional.dropout`` in training mode, drawing from the port's
generator (``framework/random.py``). ``Dropout2D``, ``Dropout3D`` and
``AlphaDropout`` wait for ROADMAP queue 1 item 5d."""
from __future__ import annotations

from torch import nn

from ..functional.common import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002 - the reference's argument name
        return dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
