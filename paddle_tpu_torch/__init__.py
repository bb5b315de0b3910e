"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The package mirrors ``paddle_tpu``'s module paths so each counterpart is
easy to find (``models/gpt.py``, ``ops/paged_attention.py``,
``serving/generation/engine.py``, ...). It imports ``torch`` and numpy only:
never ``jax`` and nothing of ``paddle_tpu``. Every TPU (Pallas) kernel on a
ported path is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``).

``import paddle_tpu_torch as paddle`` gives the Paddle-shaped eager API: the
:class:`Tensor` (a wrapper over ``torch.Tensor``, ``core/tensor.py`` says
why), the ``paddle.tensor`` op surface (also Tensor methods), autograd over
torch's, dtypes, places, ``nn.Layer`` and the ``paddle.nn`` layers and
functionals, the optimizers with the regularizers, ``amp``, ``save``/``load``,
``autograd`` (``PyLayer``, the functional transforms), ``paddle.Model``
(hapi) with its callbacks, ``metric``, ``linalg``, ``device`` and
``elastic`` (crash-safe checkpoints and preemption-tolerant training).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` (the
Paddle API: ``paddle.set_device("cpu")``); without a CUDA device and without
that request they raise. Importing the package never does.
"""
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                            no_grad, set_grad_enabled)
from .framework.dtype import (DType as dtype, bfloat16, bool_ as bool,  # noqa
                              bool_ as bool8, complex64, complex128, float16,
                              float32, float64, get_default_dtype, int8,
                              int16, int32, int64, set_default_dtype, uint8)
from .framework.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa
                              NPUPlace, Place, TPUPlace, XPUPlace)
from .framework.device import (device_count, get_device,  # noqa: F401
                               is_compiled_with_cuda, is_compiled_with_rocm,
                               is_compiled_with_tpu, is_compiled_with_xpu,
                               set_device, synchronize)
from .framework.flags import flags_snapshot, get_flags, set_flags  # noqa
from .framework.random import get_rng_state, seed, set_rng_state  # noqa
from .framework.misc import (LazyGuard, batch, check_shape,  # noqa: F401
                             disable_signal_handler, finfo, flops,
                             get_cuda_rng_state, iinfo, set_cuda_rng_state,
                             set_printoptions)
from .framework.io import load_paddle as load, save  # noqa: F401
from .nn.initializer_utils import ParamAttr  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401

from .tensor import *  # noqa: F401,F403  (also patches the Tensor methods)
from . import tensor  # noqa: F401

from . import (amp, autograd, core, device, distributed,  # noqa: F401
               elastic, framework, hapi, incubate, inference, io, jit,
               linalg, metric, nn, optimizer, profiler, regularizer, static,
               vision)
from .distributed import DataParallel  # noqa: F401
from .hapi import Model, callbacks, summary  # noqa: F401

__version__ = "0.1.0"


def in_dynamic_mode() -> bool:
    """The port runs eagerly only (``static`` holds ``InputSpec`` alone)."""
    return True


def disable_static():
    """Nothing to do: the port runs eagerly only."""


def enable_static():
    """The reference's static mode needs its static Program, which the port
    does not have yet (ROADMAP queue 1, item 5d)."""
    raise NotImplementedError(
        "enable_static: the port has no static Program yet (ROADMAP queue "
        "1, item 5d); it runs eagerly")
