"""Layers of the port (the GPT and BERT modules live in ``models/``)."""
from .common import Dropout
from .conv import Conv2D
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Dropout", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D"]
