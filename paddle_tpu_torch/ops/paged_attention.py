"""Paged KV-cache attention plumbing (PagedAttention, Kwon et al. SOSP '23).

Counterpart of ``paddle_tpu/ops/paged_attention.py``. Each sequence's K/V
lives in fixed-size pages of a preallocated per-layer pool laid out
``[num_pages, page_size, num_heads, head_dim]``; an int32 block table maps
logical position ``p`` to pool page ``table[p // page_size]`` at offset
``p % page_size``. **Page 0 is the trash page**: the allocator never hands it
out, and every masked write (padding positions, dead batch lanes) goes to a
slot inside it, so the write shapes stay fixed.

One difference from the reference: JAX donates the pools and gets new ones
back; here ``write_pool`` updates the pool **in place** (``index_copy_`` on
the flattened ``[num_pages * page_size, H, D]`` view), and
``paged_attention_update`` returns the same pool tensors it was given.

Quantized (int8) pools are not ported yet (ROADMAP queue 2, the int8
variant of the paged kernel): a tuple pool raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flat_slots", "write_pool", "gather_pool",
           "paged_attention_update", "kv_pool_bytes", "resolve_kv_dtype",
           "KINDS", "KV_DTYPES"]

KINDS = ("prefill", "decode", "chunked")
KV_DTYPES = ("", "float32", "bfloat16", "int8")
_INT8_TODO = ("int8 KV pools are not ported yet (ROADMAP queue 2: the int8 "
              "variant of the paged-attention kernel, FLAGS_decode_kv_dtype)")


def resolve_kv_dtype(name):
    """Map a FLAGS_decode_kv_dtype value to a pool dtype: '' → None (the
    model's dtype), else the torch dtype."""
    name = (name or "").strip()
    if name not in KV_DTYPES:
        raise ValueError(f"kv dtype must be one of {KV_DTYPES[1:]} (or '' "
                         f"for the model dtype), got {name!r}")
    if name == "int8":
        raise NotImplementedError(_INT8_TODO)
    return getattr(torch, name) if name else None


def _check_pool(pool):
    if isinstance(pool, (tuple, list)):
        raise NotImplementedError(_INT8_TODO)


def kv_pool_bytes(num_pages, page_size, num_heads, head_dim,
                  kv_dtype) -> int:
    """Bytes of ONE pool (K or V) per layer for a storage dtype
    ('' / None = float32, as in the reference)."""
    dt = getattr(torch, kv_dtype) if kv_dtype else torch.float32
    return (int(num_pages) * int(page_size) * num_heads * head_dim
            * torch.empty((), dtype=dt).element_size())


def flat_slots(block_tables, positions, valid, page_size: int):
    """Flat pool-slot index for each (row, position): ``page * page_size +
    offset`` through the block table, or a trash-page slot (``offset`` <
    page_size) where ``valid`` is False.

    block_tables: [B, P] int; positions: [B, S] int; valid: [B, S] bool.
    Returns [B, S] int64.
    """
    positions = positions.long()
    page_idx = torch.div(positions, page_size, rounding_mode="floor")
    offset = positions - page_idx * page_size
    # clip so dead lanes with positions past the table read page 0's entry
    page_idx = page_idx.clamp(0, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables.long(), 1, page_idx)
    slots = pages * page_size + offset
    return torch.where(valid, slots, offset)      # trash page = page 0


def write_pool(pool, slots, kv):
    """Write ``kv`` rows into the pool at flat ``slots``, in place.

    pool: [num_pages, page_size, H, D]; slots: [N] int flat slot ids; kv:
    [N, H, D]. Duplicate trash-slot writes land in an unspecified order —
    the trash page holds garbage by contract. Returns ``pool``.
    """
    _check_pool(pool)
    num_pages, page_size = pool.shape[0], pool.shape[1]
    flat = pool.view(num_pages * page_size, *pool.shape[2:])
    flat.index_copy_(0, slots.long(), kv.to(pool.dtype))
    return pool


def gather_pool(pool, block_tables):
    """Every slot a block table can address, in logical order.

    pool: [num_pages, page_size, H, D]; block_tables: [B, P] int. Returns
    [B, P * page_size, H, D] where row ``t`` holds logical position ``t``.
    """
    _check_pool(pool)
    num_pages, page_size = pool.shape[0], pool.shape[1]
    flat = pool.view(num_pages * page_size, *pool.shape[2:])
    tables = block_tables.long()
    slots = (tables[:, :, None] * page_size
             + torch.arange(page_size, device=tables.device)[None, None])
    return flat[slots.reshape(tables.shape[0], -1)]


def _decode_attention(q, ks, vs, ctx_len, scale):
    """Single-position attention against the gathered paged context.

    q: [B, 1, H, D]; ks/vs: [B, T, H, D]; ctx_len: [B] — visible context
    INCLUDING the just-written position. Scores in q's type, masked with
    -1e30 (not -inf: an all-dead lane stays finite), softmax in float, the
    probabilities cast back to q's type — the reference's maths.
    """
    logits = torch.einsum("bqhd,bthd->bhqt", q, ks) * scale
    t = ks.shape[1]
    mask = torch.arange(t, device=q.device)[None, :] < ctx_len[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", probs, vs)


def _chunked_attention(q, ks, vs, positions, valid, scale):
    """Window attention against the gathered paged context: query ``s``
    sees every logical slot ``t <= positions[b, s]`` (its cached prefix and
    the window up to itself), where ``valid[b, s]``.

    q: [B, S, H, D]; ks/vs: [B, T, H, D]; positions: [B, S]; valid: [B, S].
    """
    logits = torch.einsum("bqhd,bthd->bhqt", q, ks) * scale
    t = ks.shape[1]
    mask = (torch.arange(t, device=q.device)[None, None, :]
            <= positions[:, :, None]) & valid[:, :, None]     # [B, S, T]
    logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", probs, vs)


def paged_attention_update(q, k, v, k_pool, v_pool, block_tables, ctx_len,
                           valid, positions, *, page_size: int, kind: str,
                           use_kernels: bool = True, slots=None):
    """One layer's cache-aware attention: write this call's K/V into the
    paged pools (in place), then attend.

    q/k/v: [B, S, H, D] (any strides); pools: [num_pages, page_size, H, D];
    block_tables: [B, P]; ctx_len: [B] visible length including the
    positions written here; valid: [B, S]; positions: [B, S].

    - ``prefill``: K/V of the window are right here, so attention is
      ordinary causal attention over the window (the flash kernel); the pool
      write only persists them for later decode steps.
    - ``decode`` (S == 1) and ``chunked`` (a window at non-zero starting
      positions): write first, then read the context back through the block
      table — self is included (the paged kernel).

    ``use_kernels`` picks the hand-written kernels (the default; on CPU
    tensors their wrappers run the plain versions) or calls the kernels'
    plain versions directly, which is how the kernel path is held against
    the plain path on the card. ``slots`` are this call's
    ``flat_slots(...)`` flattened to [B*S], when the caller has them (a
    model computes them once for all its layers).

    Returns (attn_out [B, S, H, D], k_pool, v_pool).
    """
    from . import cuda_attention, cuda_paged_attention
    from .flash_attention import prefill_flash

    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    b, s, h, d = q.shape
    if slots is None:
        slots = flat_slots(block_tables, positions, valid,
                           page_size).reshape(b * s)
    write_pool(k_pool, slots, k.reshape(b * s, h, d))
    write_pool(v_pool, slots, v.reshape(b * s, h, d))
    scale = 1.0 / math.sqrt(d)
    if kind == "prefill":
        if use_kernels:
            out = prefill_flash(q, k, v, scale)
        else:
            out, _ = cuda_attention.mha_fwd_reference(q, k, v, causal=True,
                                                      scale=scale)
        return out, k_pool, v_pool
    fn = (cuda_paged_attention.paged_attention if use_kernels
          else cuda_paged_attention.paged_attention_reference)
    out = fn(q, k_pool, v_pool, block_tables, ctx_len, valid, positions,
             page_size=page_size, kind=kind, scale=scale)
    return out, k_pool, v_pool
