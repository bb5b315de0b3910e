"""Attention routing in ``[B, S, H, D]`` layout.

Counterpart of ``paddle_tpu/ops/flash_attention.py`` (``attention_bshd``)
and of ``pallas_paged_attention.prefill_flash``. The TPU gates do not carry
over: the reference only took its flash kernel for sequences that are a
multiple of 128 and at least ``FLAGS_flash_min_seqlen`` (2048) long, with
512x1024 blocks — TPU constants. The port's kernels mask ragged edges, so on
the card every window goes through them, whatever its length. What the
kernels do not take by shape (``cuda_attention.supported``: a head_dim
outside {64, 128}, another dtype, unaligned 16-bit rows) goes to their plain
versions, as the reference sends what its ``flash_attention.supported``
refuses to its dense path; such calls count in the plain versions'
``plain_calls``. A kernel that fails to build or launch raises: nothing
here catches an exception.

The gradient is :class:`FlashAttention`, the counterpart of the reference's
``pallas_attention.mha`` ``custom_vjp``: the forward kernel saves
(q, k, v, out, lse) and the backward runs the two backward kernels
(``ops/cuda_attention_bwd.py``). ``attention_bshd`` takes it whenever a
gradient is wanted; under ``torch.no_grad()`` (serving) it calls the forward
alone, as the operator ``paddle_tpu_torch::flash_attention_fwd``, and saves
nothing.

That operator (:func:`flash_attention_fwd_op`, a ``torch.library``
custom op) is what lets ``torch.export`` (``jit.save``) keep the kernel in an
exported program. The export traces with fake tensors: a ``ctypes`` launch on
``data_ptr()`` would leave no node in the graph, and ``supported`` reads
pointers a fake tensor does not have. So the graph holds one node of the
operator, whose fake implementation gives only the shapes of ``out`` and
``lse``, and the routing (``supported``, the plain version for what the
kernel refuses, the wrappers' ``launches``/``plain_calls``/``flops``) runs
inside its real implementation, where the tensors are real. A program loaded
by ``jit.load`` or an ``inference.Predictor`` launches the same kernel as the
eager model. Its outputs are contiguous on both routes (the plain version's
``out`` is a transposed view, copied here), as its fake implementation says.
"""
from __future__ import annotations

import math

import torch
from torch.overrides import handle_torch_function, has_torch_function

from .cuda_attention import flash_attention_fwd, mha_fwd_reference, supported
from .cuda_attention_bwd import flash_attention_bwd, mha_bwd_reference

__all__ = ["FlashAttention", "attention_bshd", "prefill_flash",
           "flash_attention_fwd_op", "OP_NAME"]

OP_NAME = "paddle_tpu_torch::flash_attention_fwd"


@torch.library.custom_op(OP_NAME, mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, scale: float, use_kernels: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator: the kernel where ``use_kernels`` and
    ``supported`` take the call (on CPU tensors its wrapper runs the plain
    version), else the plain version. Returns ``(out [B, Sq, H, D]
    contiguous, lse [B*H, Sq] float32)``."""
    fwd = (flash_attention_fwd
           if use_kernels and supported(q, k, v, causal)
           else mha_fwd_reference)
    out, lse = fwd(q, k, v, causal=causal, scale=scale)
    return out.contiguous(), lse


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal, scale, use_kernels):
    b, sq, h, d = q.shape
    return (q.new_empty((b, sq, h, d)),
            q.new_empty((b * h, sq), dtype=torch.float32))


def prefill_flash(q, k, v, scale):
    """Serving prefill: causal attention over the window through the flash
    kernel (``ops/cuda_attention.py``; its plain version on CPU tensors and
    for shapes the kernel does not take). q/k/v: [B, S, H, D]; returns
    [B, S, H, D]."""
    fwd = (flash_attention_fwd if supported(q, k, v, causal=True)
           else mha_fwd_reference)
    out, _ = fwd(q, k, v, causal=True, scale=scale)
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
    (their plain versions on CPU tensors, for shapes the kernels do not take,
    or anywhere with ``use_kernels=False``), differentiable in q, k and v.
    It dispatches through ``__torch_function__``, so the port's AMP
    (``amp/auto_cast.py``) casts its inputs under the reference's op name
    ``scaled_dot_product_attention``. Without a gradient it calls
    :func:`flash_attention_fwd_op`, which decides the route inside."""
    if has_torch_function((q, k, v)):
        return handle_torch_function(attention_bshd, (q, k, v), q, k, v,
                                     causal=causal, scale=scale,
                                     use_kernels=use_kernels)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad:
        use_kernels = use_kernels and supported(q, k, v, causal,
                                                backward=True)
        return FlashAttention.apply(q, k, v, causal, s, use_kernels)
    out, _ = flash_attention_fwd_op(q, k, v, causal, float(s),
                                    bool(use_kernels))
    return out
