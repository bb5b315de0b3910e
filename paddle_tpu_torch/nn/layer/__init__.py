"""Layers of the port (the GPT and BERT modules live in ``models/``)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .layers import Layer
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "Dropout", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "Identity", "Linear", "Embedding", "Flatten",
           "Sequential", "LayerList", "LayerDict", "ParameterList",
           "LayerNorm", "CrossEntropyLoss"] + list(_activations)
