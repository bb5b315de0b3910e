"""``ParamAttr`` and parameter construction: the port of
``paddle_tpu/nn/initializer_utils.py``. A ``regularizer``
(``paddle_tpu_torch.regularizer``) rides on the parameter, where the
optimizers read it."""
from __future__ import annotations

from ..core.tensor import Parameter
from ..framework import dtype as dtype_mod
from . import initializer as I

__all__ = ["ParamAttr", "create_parameter_with_attr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def create_parameter_with_attr(shape, dtype, attr=None, is_bias=False,
                               default_initializer=None):
    """A :class:`Parameter` as ``attr`` describes it (``False``: no
    parameter); the initializer is the attr's, else the layer's default,
    else the global one, else zeros for a bias and Xavier-normal for a
    weight, as the reference."""
    if attr is False:
        return None
    if attr is None or attr is True:
        attr = ParamAttr()
    elif isinstance(attr, str):
        attr = ParamAttr(name=attr)
    elif isinstance(attr, I.Initializer):
        attr = ParamAttr(initializer=attr)
    init = attr.initializer or default_initializer or \
        I.global_initializer(is_bias)
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    data = init(tuple(int(s) for s in shape),
                dtype_mod.to_torch_dtype(dtype or "float32"))
    p = Parameter(data, name=attr.name, trainable=attr.trainable)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.is_bias = is_bias
    return p
