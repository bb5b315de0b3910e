"""Functionals of the port that the training paths need."""
from .attention import scaled_dot_product_attention, sdpa_dense
from .common import dropout
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "conv2d", "cross_entropy",
           "dropout", "max_pool2d", "scaled_dot_product_attention",
           "sdpa_dense"]
