"""Attention routing in ``[B, S, H, D]`` layout.

Counterpart of ``paddle_tpu/ops/flash_attention.py`` (``attention_bshd``)
and of ``pallas_paged_attention.prefill_flash``. The TPU gates do not carry
over: the reference only took its flash kernel for sequences that are a
multiple of 128 and at least ``FLAGS_flash_min_seqlen`` (2048) long, with
512x1024 blocks — TPU constants. The port's kernels mask ragged edges, so on
the card every window goes through them, whatever its length, and there is
no dense branch to fall back to.

The gradient is :class:`FlashAttention`, the counterpart of the reference's
``pallas_attention.mha`` ``custom_vjp``: the forward kernel saves
(q, k, v, out, lse) and the backward runs the two backward kernels
(``ops/cuda_attention_bwd.py``). ``attention_bshd`` takes it whenever a
gradient is wanted; under ``torch.no_grad()`` (serving) it calls the forward
alone and saves nothing.
"""
from __future__ import annotations

import math

import torch
from torch.overrides import handle_torch_function, has_torch_function

from .cuda_attention import flash_attention_fwd, mha_fwd_reference
from .cuda_attention_bwd import flash_attention_bwd, mha_bwd_reference

__all__ = ["FlashAttention", "attention_bshd", "prefill_flash"]


def prefill_flash(q, k, v, scale):
    """Serving prefill: causal attention over the window through the flash
    kernel (``ops/cuda_attention.py``; its plain version on CPU tensors).
    q/k/v: [B, S, H, D]; returns [B, S, H, D]."""
    out, _ = flash_attention_fwd(q, k, v, causal=True, scale=scale)
    return out


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, then the dq and
    dk/dv kernels from the saved (q, k, v, out, lse). ``use_kernels=False``
    runs the kernels' plain versions instead, on any device (the plain
    path the smoke holds the kernels against)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, use_kernels=True):
        fwd = flash_attention_fwd if use_kernels else mha_fwd_reference
        out, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.use_kernels = causal, scale, use_kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if ctx.use_kernels else mha_bwd_reference
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(),
                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def attention_bshd(q, k, v, causal=False, scale=None, use_kernels=True):
    """Maskless attention in [B, S, H, D] layout through the flash kernels
    (their plain versions on CPU tensors, or anywhere with
    ``use_kernels=False``), differentiable in q, k and v. It dispatches
    through ``__torch_function__``, so the port's AMP
    (``amp/auto_cast.py``) casts its inputs under the reference's op name
    ``scaled_dot_product_attention``."""
    if has_torch_function((q, k, v)):
        return handle_torch_function(attention_bshd, (q, k, v), q, k, v,
                                     causal=causal, scale=scale,
                                     use_kernels=use_kernels)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, s, use_kernels)
    fwd = flash_attention_fwd if use_kernels else mha_fwd_reference
    out, _ = fwd(q, k, v, causal=causal, scale=s)
    return out
