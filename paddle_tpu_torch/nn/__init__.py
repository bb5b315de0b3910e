"""``paddle.nn`` of the port: ``Layer``, the containers, the layers a
transformer script uses, the five layers the port's models are built from,
the activations, the grad clips, ``ParamAttr`` and the initializers (the
GPT and BERT modules live in ``models/``)."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer_utils import ParamAttr
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "ParamAttr", "functional", "initializer"] + list(_layers)
