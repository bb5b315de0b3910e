"""Layers and functionals of the port (the GPT and BERT modules live in
``models/``, ResNet in ``vision/models/``)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, MaxPool2D

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D"]
