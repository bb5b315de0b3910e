"""``paddle.nn`` of the port: ``Layer``, the containers, every layer of the
reference's ``paddle_tpu.nn`` (common, activations, convolutions, pools,
norms, paddings, losses, recurrent and transformer layers), beam-search
decoding, the grad clips, ``ParamAttr`` and the initializers (the GPT and
BERT modules live in ``models/``)."""
from . import functional, initializer  # noqa: F401
from . import functional as F  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer_utils import ParamAttr, create_parameter_with_attr
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from . import decode, utils, utils_helpers  # noqa: F401,E402
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: E402

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "ParamAttr", "create_parameter_with_attr", "functional", "F",
           "initializer", "decode", "utils", "utils_helpers",
           "BeamSearchDecoder", "dynamic_decode"] + list(_layers)
