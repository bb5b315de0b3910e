"""Automatic mixed precision of the port (``auto_cast``, O1/O2; ``decorate``,
O2's cast of a model) and dynamic loss scaling (``GradScaler``)."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_guard, amp_state,
                        auto_cast, decorate)
from . import grad_scaler  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate", "WHITE_LIST",
           "BLACK_LIST", "GradScaler", "AmpScaler", "grad_scaler"]
