"""Functionals of the port: ``paddle.nn.functional``'s names that the
training paths and the Paddle API's transformer layers need."""
from .activation import (celu, elu, elu_, gelu, glu, gumbel_softmax,
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softmax_, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink, thresholded_relu)
from .attention import flash_attention, scaled_dot_product_attention, \
    sdpa_dense
from .common import dropout, embedding, linear
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "conv2d", "cross_entropy",
           "dropout", "max_pool2d", "scaled_dot_product_attention",
           "sdpa_dense", "flash_attention", "linear", "embedding",
           "layer_norm", "celu", "elu", "elu_", "gelu", "glu",
           "gumbel_softmax", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "leaky_relu", "log_sigmoid", "log_softmax", "maxout",
           "mish", "prelu", "relu", "relu6", "relu_", "rrelu", "selu",
           "sigmoid", "silu", "softmax", "softmax_", "softplus",
           "softshrink", "softsign", "swish", "tanh", "tanhshrink",
           "thresholded_relu"]
