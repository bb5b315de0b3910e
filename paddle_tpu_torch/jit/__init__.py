"""The port's training step (``TrainStep``)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
