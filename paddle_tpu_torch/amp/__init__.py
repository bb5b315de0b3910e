"""Automatic mixed precision of the port (``auto_cast``, O1/O2)."""
from .auto_cast import BLACK_LIST, WHITE_LIST, amp_state, auto_cast

__all__ = ["auto_cast", "amp_state", "WHITE_LIST", "BLACK_LIST"]
