"""The port's training step (``TrainStep``) and model export
(``save``/``load``)."""
from .api import TranslatedLayer, load, save
from .train_step import TrainStep

__all__ = ["TrainStep", "save", "load", "TranslatedLayer"]
