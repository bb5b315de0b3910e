"""Functionals of the port that the training path needs."""
from .attention import scaled_dot_product_attention, sdpa_dense
from .common import dropout
from .loss import cross_entropy

__all__ = ["cross_entropy", "dropout", "scaled_dot_product_attention",
           "sdpa_dense"]
