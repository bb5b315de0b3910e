"""Attention routing in ``[B, S, H, D]`` layout.

Counterpart of ``paddle_tpu/ops/flash_attention.py`` (``attention_bshd``)
and of ``pallas_paged_attention.prefill_flash``. The TPU gates do not carry
over: the reference only took its flash kernel for sequences that are a
multiple of 128 and at least ``FLAGS_flash_min_seqlen`` (2048) long, with
512x1024 blocks — TPU constants. The port's kernel masks ragged edges, so on
the card every window goes through it, whatever its length, and there is no
dense branch to fall back to.
"""
from __future__ import annotations

import math

from .cuda_attention import flash_attention_fwd

__all__ = ["attention_bshd", "prefill_flash"]


def prefill_flash(q, k, v, scale):
    """Serving prefill: causal attention over the window through the flash
    kernel (``ops/cuda_attention.py``; its plain version on CPU tensors).
    q/k/v: [B, S, H, D]; returns [B, S, H, D]."""
    out, _ = flash_attention_fwd(q, k, v, causal=True, scale=scale)
    return out


def attention_bshd(q, k, v, causal=False, scale=None):
    """Maskless attention in [B, S, H, D] layout through the flash kernel
    (its plain version on CPU tensors)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out, _ = flash_attention_fwd(q, k, v, causal=causal, scale=s)
    return out
