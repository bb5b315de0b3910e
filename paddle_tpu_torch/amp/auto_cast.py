"""Automatic mixed precision: the port of ``paddle_tpu/amp/auto_cast.py``.

The reference casts at its dispatch boundary (``core/dispatch.py:63-67``):
before an op runs, its floating inputs are cast by the op's name.

- O1: ops on ``WHITE_LIST`` (matmul-class) take the amp dtype;
- O2: every op that is not on ``BLACK_LIST`` takes the amp dtype;
- either level: ops on ``BLACK_LIST`` (``layer_norm``, ``softmax``,
  ``cross_entropy``, ...) take float32, so a layer norm *outputs* float32 and
  the next linear casts that output back.

Master parameters stay float32 and their gradients come back float32
through the casts' backward. ``torch.autocast`` does not reproduce this: with
float32 master weights it would leave the embedding sum and the residual
stream in float32, where the reference keeps both in bf16 under O2.

The port applies the rule with a ``TorchFunctionMode`` at the torch
functions that stand for the ops the reference dispatches in the GPT step,
under the reference's names (``_OP_NAMES``): ``embedding``,
``getitem``, ``add``, ``layer_norm``, ``linear``, ``reshape``,
``scaled_dot_product_attention`` (the port's ``attention_bshd``), ``gelu``,
``matmul`` and ``cross_entropy``; every other torch call passes through
unchanged. Nested ``auto_cast`` blocks replace the state, as the
reference's do, rather than stacking casts.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["auto_cast", "amp_state", "WHITE_LIST", "BLACK_LIST"]

# the reference's lists (paddle_tpu/amp/auto_cast.py:22-33)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "mm", "bmm", "mv",
    "scaled_dot_product_attention", "addmm",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "c_softmax_with_cross_entropy", "layer_norm", "erf",
    "logsumexp", "log_softmax", "batch_norm", "group_norm", "instance_norm",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_state = threading.local()
_OP_NAMES = None


def _op_names() -> dict:
    """torch function → the reference's op name (built at first use: it
    imports the port's own ops)."""
    global _OP_NAMES
    if _OP_NAMES is None:
        from ..nn.functional.loss import cross_entropy
        from ..ops.flash_attention import attention_bshd
        T = torch.Tensor
        names = {
            F.embedding: "embedding",
            T.__getitem__: "getitem",
            T.add: "add", T.__add__: "add", T.__radd__: "add",
            torch.add: "add",
            F.layer_norm: "layer_norm",
            F.linear: "linear",
            T.view: "reshape", T.reshape: "reshape", torch.reshape: "reshape",
            attention_bshd: "scaled_dot_product_attention",
            F.gelu: "gelu",
            torch.matmul: "matmul", T.matmul: "matmul",
            T.__matmul__: "matmul",
            cross_entropy: "cross_entropy",
        }
        _OP_NAMES = names
    return _OP_NAMES


def amp_state():
    """The active AMP state ``(level, dtype)``, or None."""
    return getattr(_state, "amp", None)


def cast_dtype(name: str):
    """The dtype the rule casts ``name``'s floating inputs to under the
    active state, or None to leave them (``maybe_autocast_args``)."""
    st = amp_state()
    if st is None:
        return None
    level, dtype = st
    if name in BLACK_LIST:
        return torch.float32
    if name in WHITE_LIST or level == "O2":
        return dtype
    return None


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point() and \
            x.dtype not in (torch.float64, dtype):
        return x.to(dtype)
    return x


class _AmpMode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_names().get(func)
        dtype = cast_dtype(name) if name is not None else None
        if dtype is not None:
            args = tuple(_cast(a, dtype) for a in args)
            kwargs = {k: _cast(v, dtype) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def auto_cast(enable=True, level="O1", dtype="bfloat16"):
    """Run the block under the reference's AMP rule (see the module
    docstring): ``level`` "O1" or "O2", ``dtype`` "bfloat16" or "float16";
    ``enable=False`` turns the rule off inside an enclosing block."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    prev = amp_state()
    new = (level, _DTYPES[dtype]) if enable else None
    # one mode per thread reads the state; a nested block swaps the state
    mode = _AmpMode() if prev is None and new is not None else None
    _state.amp = new
    try:
        if mode is None:
            yield
        else:
            with mode:
                yield
    finally:
        _state.amp = prev
