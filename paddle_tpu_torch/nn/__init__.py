"""Layers and functionals of the port (the GPT modules live in
``models/gpt.py``)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout"]
