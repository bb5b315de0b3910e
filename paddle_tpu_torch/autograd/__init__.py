"""``paddle.autograd``: the port of ``paddle_tpu/autograd/`` (``backward``,
``grad``, the grad-mode switches, ``saved_tensors_hooks``, ``PyLayer`` and
the functional transforms), over ``torch.autograd``."""
from ..core.autograd import (backward, enable_grad, grad,  # noqa: F401
                             is_grad_enabled, no_grad, saved_tensors_hooks)
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext  # noqa: F401

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "saved_tensors_hooks", "PyLayer", "PyLayerContext",
           "LegacyPyLayer", "jacobian", "hessian", "vjp", "jvp"]
