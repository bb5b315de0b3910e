"""Layers of the port (the GPT modules live in ``models/gpt.py``)."""
from .common import Dropout

__all__ = ["Dropout"]
