"""``paddle.linalg``: the port of ``paddle_tpu/linalg.py``, a re-export of
what ``tensor/linalg.py`` defines (its imported helpers left out by module
of origin, as the reference filters them)."""
from .tensor.linalg import *  # noqa: F401,F403
from .tensor import linalg as _tl

__all__ = sorted(
    n for n in dir(_tl)
    if not n.startswith("_") and callable(getattr(_tl, n))
    and getattr(getattr(_tl, n), "__module__", "") == _tl.__name__)
