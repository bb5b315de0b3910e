"""Common layers: the port of ``paddle_tpu/nn/layer/common.py``
(``Identity``, ``Linear`` with its ``[in, out]`` weight, ``Embedding`` with
``padding_idx``, the dropouts, ``Flatten``, the resizes, ``Bilinear``, the
pixel and channel shuffles, the paddings, ``Fold``/``Unfold`` and the two
distances). The dropouts draw their masks from the port's generator
(``framework/random.py``)."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Bilinear",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
           "CosineSimilarity", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "Unfold", "Fold", "PairwiseDistance"]


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
        return F.linear(input, self.weight, self.bias)

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
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    """``nn.functional.dropout`` in training mode (``train()``/``eval()``
    switch it)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002
        return F.dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout2d(input, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout3d(input, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):  # noqa: A002
        return F.alpha_dropout(input, self.p, self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):  # noqa: A002
        from ...tensor.manipulation import flatten
        return flatten(input, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Bilinear(Layer):
    """``out = x1 · weight · x2 + bias``, weight ``[out, in1, in2]``
    (Xavier-normal), bias ``[out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = create_parameter_with_attr(
            [out_features, in1_features, in2_features], self._dtype,
            weight_attr, False)
        self.bias = create_parameter_with_attr(
            [out_features], self._dtype, bias_attr, True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, name)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)
