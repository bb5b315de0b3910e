"""Serving layer of the port (this slice: the generation engine)."""
from .request import DeadlineExceededError, QueueFullError, ServerClosedError

__all__ = ["DeadlineExceededError", "QueueFullError", "ServerClosedError"]
