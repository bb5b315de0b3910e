"""Optimizers and LR schedulers of the port."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
