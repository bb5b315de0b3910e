"""Vision models of the port."""
from . import models  # noqa: F401

__all__ = ["models"]
