"""Common layers: the port of ``paddle_tpu/nn/layer/common.py``
(``Identity``, ``Linear`` with its ``[in, out]`` weight, ``Embedding`` with
``padding_idx``, ``Dropout``, ``Flatten``). ``Dropout`` draws its mask from
the port's generator (``framework/random.py``). ``Dropout2D``,
``Dropout3D``, ``AlphaDropout`` and the other common layers wait for ROADMAP
queue 1 item 5d, part 2."""
from __future__ import annotations

import torch

from .. import initializer as I
from ..functional.common import dropout, embedding, linear
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Flatten"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):  # noqa: A002 - the reference's argument name
        return input


class Linear(Layer):
    """``y = x @ weight + bias``; ``weight`` is ``[in_features,
    out_features]`` (Xavier-normal by default), ``bias`` zeros unless
    ``bias_attr=False``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = create_parameter_with_attr(
            [in_features, out_features], self._dtype, weight_attr, False)
        self.bias = create_parameter_with_attr(
            [out_features], self._dtype, bias_attr, True)

    def forward(self, input):  # noqa: A002
        return linear(input, self.weight, self.bias)

    def extra_repr(self):
        w = self._parameters["weight"]
        return f"in_features={w.shape[0]}, out_features={w.shape[1]}"


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table (Xavier-normal by
    default; the ``padding_idx`` row starts at zero and its ids give
    zeros)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        self.weight = create_parameter_with_attr(
            [num_embeddings, embedding_dim], self._dtype, weight_attr, False,
            default_initializer=I.XavierNormal())
        if padding_idx is not None:
            with torch.no_grad():
                self._parameters["weight"][padding_idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    """``nn.functional.dropout`` in training mode (``train()``/``eval()``
    switch it)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002
        return dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):  # noqa: A002
        from ...tensor.manipulation import flatten
        return flatten(input, self.start_axis, self.stop_axis)

