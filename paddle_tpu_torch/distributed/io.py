"""``paddle.distributed.io``: the port of ``paddle_tpu/distributed/io.py``.
The crash-safe checkpoint layer (``framework/checkpoint.py``) is the real
mechanism; these keep the reference's entry points."""
from __future__ import annotations

import os

__all__ = ["save_persistables", "load_persistables", "is_persistable"]


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """Save ``main_program``'s (a layer's) state dict under ``dirname``."""
    from ..framework.io import save
    if main_program is None or not hasattr(main_program, "state_dict"):
        raise TypeError(
            "save_persistables needs a program/layer exposing "
            "state_dict(); got "
            f"{type(main_program).__name__} (silently writing an empty "
            "checkpoint would lose the training state)")
    os.makedirs(dirname or ".", exist_ok=True)
    save(main_program.state_dict(),
         os.path.join(dirname or ".", filename or "__params__"))


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    from ..framework.io import load
    return load(os.path.join(dirname or ".", filename or "__params__"))


def is_persistable(var):
    return getattr(var, "persistable", True)
