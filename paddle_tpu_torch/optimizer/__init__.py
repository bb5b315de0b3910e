"""Optimizers and LR schedulers of the port."""
from . import lr  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, LarsMomentumOptimizer, Momentum,
                        Optimizer, RMSProp)

__all__ = ["lr", "optimizer", "Optimizer", "SGD", "Momentum", "LarsMomentum",
           "LarsMomentumOptimizer", "Adam", "AdamW", "Adagrad", "Adadelta",
           "Adamax", "RMSProp", "Lamb"]
