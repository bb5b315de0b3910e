"""``paddle.nn.functional`` of the port: every name of the reference's
(``paddle_tpu/nn/functional/__init__.py``), as torch code."""
from ...core.tensor import Tensor  # noqa: F401 - the reference exports it
from ...tensor.manipulation import diag_embed  # noqa: F401
from ...tensor.math import tanh_  # noqa: F401
from .activation import (celu, elu, elu_, gelu, glu, gumbel_softmax,
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softmax_, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink, thresholded_relu)
from .attention import (flash_attention, scaled_dot_product_attention,
                        sdpa_dense, sparse_attention)
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, spectral_norm)
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling

__all__ = (["Tensor", "diag_embed", "tanh_", "flash_attention",
            "scaled_dot_product_attention", "sdpa_dense", "sparse_attention",
            "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose",
            "conv3d", "conv3d_transpose", "batch_norm", "group_norm",
            "instance_norm", "layer_norm", "local_response_norm",
            "normalize", "spectral_norm", "celu", "elu", "elu_", "gelu",
            "glu", "gumbel_softmax", "hardshrink", "hardsigmoid",
            "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
            "log_softmax", "maxout", "mish", "prelu", "relu", "relu6",
            "relu_", "rrelu", "selu", "sigmoid", "silu", "softmax",
            "softmax_", "softplus", "softshrink", "softsign", "swish",
            "tanh", "tanhshrink", "thresholded_relu"] + list(_common)
           + list(_loss) + list(_pooling))
