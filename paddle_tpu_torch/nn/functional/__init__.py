"""Functionals of the port that the training path needs."""
from .loss import cross_entropy

__all__ = ["cross_entropy"]
