"""``einsum``: the port of ``paddle_tpu/tensor/einsum.py``."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op


def einsum(equation, *operands, name=None):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op("einsum", lambda *xs: torch.einsum(equation, *xs),
                    *operands)
