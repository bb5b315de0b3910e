"""Scaled dot-product attention with the reference's routing
(``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention(q, k, v, attn_mask, dropout_p, is_causal,
training)`` in ``[B, S, H, D]`` layout goes where the reference sends it:
without a mask and without dropout (``p == 0``, or outside training) to the
flash path (``ops/flash_attention.attention_bshd``: the hand-written
kernels, or their plain versions for shapes they refuse), and otherwise to
the dense path, :func:`sdpa_dense`, the port of ``_sdpa_reference``. The
dense path is the reference's own route for a mask or dropout, not a shape a
kernel refused: its calls count in ``dense_calls`` (a plain module-level
integer), apart from the kernels' ``plain_calls``. Probability dropout
inside the flash kernels would be a feature the reference lacks.

``sparse_attention`` (the reference's ``:99-156``) is masked dense attention
from a concrete CSR pattern: the pattern becomes an additive mask on the
host and the call goes through :func:`sdpa_dense`, as the reference
computes it densely.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op
from ...ops.cuda_attention import NEG_INF
from ...ops.flash_attention import attention_bshd
from .common import keep_mask

__all__ = ["scaled_dot_product_attention", "sdpa_dense", "flash_attention",
           "sparse_attention"]

dense_calls = 0


def sdpa_dense(q, k, v, mask=None, causal=False, scale=None,
               keep: Optional[torch.Tensor] = None, dropout_p: float = 0.0):
    """The reference's dense attention (``_sdpa_reference``, ``:18-48``) as
    written: scores ``q kᵀ · scale`` in q's type, the causal mask
    (top-left aligned ``tril(k = sk - sq)``) as ``NEG_INF`` in the scores'
    type (-inf in float16, as the reference's cast makes it), an additive
    ``mask``, softmax in float32 cast back to q's type, then — with a
    ``keep`` mask ``[B, H, Sq, Sk]`` — ``where(keep, p / (1 - dropout_p),
    0)``, and the product with v. A function of an explicit ``keep``, so
    that a test can feed the reference and the port the same mask.
    q: ``[B, Sq, H, D]``; k/v: ``[B, Sk, H, D]``; returns ``[B, Sq, H, D]``.
    """
    global dense_calls
    dense_calls += 1
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * s
    if causal:
        sq, sk = logits.shape[-2:]
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.matmul(probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None,
                                 use_kernels=True, name=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` in
    ``[B, S, H, D]`` layout: the flash path without a mask and without
    dropout, the dense path (:func:`sdpa_dense`, its keep mask drawn from
    the port's generator) otherwise, as the reference routes. It dispatches
    through ``__torch_function__``, so the port's AMP casts its inputs under
    the reference's op name ``scaled_dot_product_attention``."""
    args = (query, key, value) + (() if attn_mask is None else (attn_mask,))
    if has_torch_function(args):
        return handle_torch_function(
            scaled_dot_product_attention, args, query, key, value,
            attn_mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal,
            training=training, scale=scale, use_kernels=use_kernels)
    p = dropout_p if training else 0.0
    if attn_mask is None and p == 0.0:
        return attention_bshd(query, key, value, causal=is_causal,
                              scale=scale, use_kernels=use_kernels)
    keep = None
    if p > 0.0:
        b, sq, h, _ = query.shape
        keep = keep_mask((b, h, sq, key.shape[1]), p, query.device)
    return sdpa_dense(query, key, value, attn_mask, is_causal, scale, keep,
                      p)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention`` (the reference's
    ``attention.py:88``): :func:`scaled_dot_product_attention` without a
    mask; returns ``(out, None)`` (the softmax is never materialised)."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal, training), None


def _csr_allowed(offsets, columns, s: int) -> np.ndarray:
    """The dense ``[..., s, s]`` allow-mask of CSR rows (``offsets``
    ``[..., s + 1]``, ``columns`` ``[..., nnz]``)."""
    lead = offsets.shape[:-1]
    offs = offsets.reshape(-1, offsets.shape[-1])
    cols = columns.reshape(-1, columns.shape[-1])
    out = np.zeros((offs.shape[0], s, s), bool)
    for i in range(offs.shape[0]):
        for r in range(s):
            out[i, r, cols[i, offs[i, r]:offs[i, r + 1]]] = True
    return out.reshape(lead + (s, s))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[B, H, S, D]`` tensors restricted to a CSR pattern
    (``[B, H, S + 1]`` offsets and ``[B, H, nnz]`` columns, or one pattern
    for all): positions outside it, and keys where ``key_padding_mask``
    ``[B, S]`` is 0, get -1e30 before the softmax; ``attn_mask`` is added.
    Returns ``[B, H, S, D]``."""
    def host(t):
        t = t._data if hasattr(t, "_data") else t
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    def fn(q, k, v, *extra):
        s = q.shape[-2]
        allowed = torch.as_tensor(_csr_allowed(
            host(sparse_csr_offset), host(sparse_csr_columns), s),
            device=q.device)
        if allowed.dim() == 2:
            allowed = allowed[None, None]
        neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
        mask = torch.where(allowed, torch.zeros((), device=q.device), neg)
        i = 0
        if key_padding_mask is not None:
            keep = extra[i].to(torch.bool)[:, None, None, :]
            mask = torch.where(keep, mask, mask + neg)
            i += 1
        if attn_mask is not None:
            mask = mask + extra[i].float()
        out = sdpa_dense(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), mask)
        return out.transpose(1, 2)
    extra = tuple(t for t in (key_padding_mask, attn_mask) if t is not None)
    return apply_op("sparse_attention", fn, query, key, value, *extra)
