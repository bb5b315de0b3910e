"""``paddle.hapi``: the high-level ``Model`` API, its callbacks and
``summary`` (the port of ``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401

__all__ = ["Model", "summary", "callbacks"]
