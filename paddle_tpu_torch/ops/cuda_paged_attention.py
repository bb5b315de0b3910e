"""Paged attention (decode and chunked): the CUDA kernel's wrapper and its
plain version.

Kernel: ``csrc/paged_attention.cu``, the port of the TPU kernel
``paddle_tpu/ops/pallas_paged_attention.py::paged_attention`` (body
``_paged_kernel``, ``pl.pallas_call`` at ``pallas_paged_attention.py:259``),
for float32, bfloat16 and int8 pools.

- What it computes: attention of each window position over its sequence's
  K/V, read through the block table inside the kernel (the gathered context
  never exists), with an online softmax in float. Masks: ``decode``
  ``t < ctx_len[b]``; ``chunked`` ``t <= positions[b, s] & valid[b, s]``
  (and ``t < ctx_len[b]``: the reference's kernel never loads a tile past
  the context either). Dead rows — no visible slot — write zeros. An int8
  pool is the ``(values int8 [N, page, H, D], scales f32 [N, page, H])``
  tuple: each row is dequantized in its load and everything after runs in
  float, as the reference's quantized branch (``:95-101, :139-144``).
- What bounds it on the H100: the bytes of the live context (decode does
  ``4*D`` flops per slot and head), so HBM bandwidth: ``2*D`` bytes per
  slot and head in bf16, ``D + 4`` in int8.
- What its design does about it: each block loads its own page ids and
  walks only the live tokens with coalesced vector loads straight from the
  pool; its eight warps split the context and merge their softmax states
  once (``csrc/paged_attention.cu`` has the details).

``paged_attention`` launches the kernel for CUDA tensors and raises on what
the kernel does not take; only CPU tensors take the plain version
``paged_attention_reference``. ``launches`` counts kernel launches
(``launches_by`` by kind and pool type, e.g. ``("chunked", "int8")``),
``plain_calls`` calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .paged_attention import (_chunked_attention, _decode_attention,
                              gather_pool, is_quantized_pool)

__all__ = ["paged_attention", "paged_attention_reference", "HEAD_DIMS",
           "MAX_PAGE_SIZE", "REPLACES", "SOURCE"]

HEAD_DIMS = (64, 128)
MAX_PAGE_SIZE = 64
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas_paged_attention.py:259"
_KIND_CODES = {"decode": 0, "chunked": 1}

launches = 0
launches_by = {}
plain_calls = 0


def paged_attention_reference(q, k_pool, v_pool, block_tables, ctx_len,
                              valid, positions, *, page_size: int,
                              kind: str, scale: float):
    """Plain PyTorch version of the kernel: gather the whole table's
    context (int8 pools dequantized to float32), then attend with the
    reference's masked softmax (``_decode_attention`` /
    ``_chunked_attention``) in float, and write zeros for dead rows (unlike
    the reference's pure path, whose dead rows hold an average of garbage)
    so the kernel can be held against it on every row. Returns [B, S, H, D]
    in q's type."""
    global plain_calls
    plain_calls += 1
    if kind not in _KIND_CODES:
        raise ValueError(f"kind must be 'decode' or 'chunked', got {kind!r}")
    values = k_pool[0] if is_quantized_pool(k_pool) else k_pool
    if values.shape[1] != page_size:
        raise ValueError(f"pool page size {values.shape[1]} != "
                         f"page_size={page_size}")
    ks = gather_pool(k_pool, block_tables, out_dtype=torch.float32).float()
    vs = gather_pool(v_pool, block_tables, out_dtype=torch.float32).float()
    qf = q.float()
    ctx = ctx_len.long()
    if kind == "decode":
        out = _decode_attention(qf, ks, vs, ctx, scale)
        live = (ctx > 0)[:, None].expand(q.shape[0], q.shape[1])
    else:
        # the kernel's mask t <= positions & valid & t < ctx, written as
        # the reference's t <= min(positions, ctx - 1)
        pos = torch.minimum(positions.long(), ctx[:, None] - 1)
        out = _chunked_attention(qf, ks, vs, pos, valid.bool(), scale)
        live = valid.bool() & (pos >= 0)
    out = torch.where(live[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _as_i32(t, name, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _check_pool(name, pool, q, page_size, h, d):
    """The kernel's pool contract: contiguous, 16-byte aligned, on q's
    device, [N, page_size, H, D] values in q's type or int8, and for int8
    f32 scales [N, page_size, H]. Returns (values, scales or None)."""
    scales = None
    if is_quantized_pool(pool):
        values, scales = pool
        if values.dtype != torch.int8:
            raise TypeError(f"{name} values must be int8, got {values.dtype}")
        if scales.device != q.device or scales.dtype != torch.float32:
            raise TypeError(f"{name} scales are {scales.dtype} on "
                            f"{scales.device}; the kernel takes float32 on "
                            f"{q.device}")
        if tuple(scales.shape) != (values.shape[0], page_size, h) or \
                not scales.is_contiguous():
            raise ValueError(
                f"{name} scales must be a contiguous [{values.shape[0]}, "
                f"{page_size}, {h}] pool, got {tuple(scales.shape)}")
    else:
        values = pool
        if values.dtype != q.dtype:
            raise TypeError(f"{name} is {values.dtype}; q is {q.dtype}")
    if values.device != q.device:
        raise TypeError(f"{name} is on {values.device}; q on {q.device}")
    if values.dim() != 4 or values.shape[1:] != (page_size, h, d) or \
            not values.is_contiguous() or values.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned [num_pages, "
            f"{page_size}, {h}, {d}] pool, got {tuple(values.shape)}")
    return values, scales


def paged_attention(q, k_pool, v_pool, block_tables, ctx_len, valid,
                    positions, *, page_size: int, kind: str, scale: float):
    """Paged attention through the block table (kinds ``decode`` and
    ``chunked``).

    q: [B, S, H, D] (any strides with a contiguous last dim); pools:
    [num_pages, page_size, H, D] contiguous in q's type, or int8 (values,
    scales) tuples; block_tables: [B, P]; ctx_len: [B]; valid/positions:
    [B, S]. The caller has already written this step's K/V into the pools.
    Returns [B, S, H, D] in q's type. CUDA tensors launch
    ``csrc/paged_attention.cu`` on the current stream (no synchronisation);
    CPU tensors take :func:`paged_attention_reference`.
    """
    global launches
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, ctx_len, valid, positions,
            page_size=page_size, kind=kind, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if kind not in _KIND_CODES:
        raise ValueError(f"kind must be 'decode' or 'chunked', got {kind!r}")
    if q.dim() != 4 or q.stride(-1) != 1:
        raise ValueError("q must be [B, S, H, D] with a contiguous head_dim")
    b, s, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if is_quantized_pool(k_pool) != is_quantized_pool(v_pool):
        raise TypeError("k_pool and v_pool must both be int8 tuples or "
                        "both tensors")
    k_vals, k_sc = _check_pool("k_pool", k_pool, q, page_size, h, d)
    v_vals, v_sc = _check_pool("v_pool", v_pool, q, page_size, h, d)
    if k_vals.shape != v_vals.shape:
        raise ValueError("k_pool and v_pool differ in shape")
    if not 1 <= page_size <= MAX_PAGE_SIZE:
        raise ValueError(f"page_size must be in [1, {MAX_PAGE_SIZE}], got "
                         f"{page_size}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be [{b}, P], got "
                         f"{tuple(block_tables.shape)}")
    for name, t in (("block_tables", block_tables), ("ctx_len", ctx_len),
                    ("valid", valid), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    n_tab = block_tables.shape[1]
    tables = _as_i32(block_tables, "block_tables", (b, n_tab))
    ctx = _as_i32(ctx_len, "ctx_len", (b,))
    pos = _as_i32(positions, "positions", (b, s))
    if tuple(valid.shape) != (b, s):
        raise ValueError(f"valid must be {(b, s)}, got {tuple(valid.shape)}")
    val = valid.to(torch.bool).contiguous()       # one byte per position
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b * s * h == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_paged_attention(
            q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
            k_sc.data_ptr() if k_sc is not None else None,
            v_sc.data_ptr() if v_sc is not None else None,
            out.data_ptr(), tables.data_ptr(), ctx.data_ptr(),
            val.data_ptr(), pos.data_ptr(), b, s, h, d, k_vals.shape[0],
            page_size, n_tab, q.stride(0), q.stride(1), q.stride(2),
            float(scale), _KIND_CODES[kind],
            _build.DTYPE_CODES[str(q.dtype)],
            _build.DTYPE_CODES[str(k_vals.dtype)], stream)
    _build.check(err, "paged_attention")
    launches += 1
    key = (kind, str(k_vals.dtype).replace("torch.", ""))
    launches_by[key] = launches_by.get(key, 0) + 1
    return out
