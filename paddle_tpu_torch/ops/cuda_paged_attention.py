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
  tuple, whose maths follows the reference's float32 quantized branch
  (``:95-101, :139-144``).
- What bounds it on the H100: the bytes of the live context (decode does
  ``4*D`` flops per slot and head), so HBM bandwidth: ``4*D`` bytes per
  slot and head in float32, ``2*D`` in bf16, ``D + 4`` in int8; a long
  float32 window is bound by its products (3xTF32: three TF32 products a
  product).
- What its design does about it (``KERNELS``; ``csrc/paged_attention.cu``
  has the details): windows (chunked, and decode calls of several rows a
  sequence) take a tensor-core window kernel: K/V tiles gathered through
  the table with ``cp.async`` into a shared-memory ring, S = Q Kᵀ and
  O += P V on ``mma.sync``, int8's K scale factored out of the dot and its
  V scale folded into p. bf16 queries run it in bf16 with P as bf16 hi +
  lo; float32 queries in 3xTF32 (each float split into TF32 hi + lo, three
  products, two over int8 pools, whose values are exact in TF32), each
  8-dim score step and each tile's P V summed from zero and joined to its
  float accumulator in one add. A decode step (one row a sequence) takes a
  split-context decode kernel in exact float FMAs, for either q type: each
  row's context in chunks (128 tokens; 64 over float pools), one block
  each. Windows of at most 16 rows split their context too, and a combine
  kernel merges the parts' softmax states, kept in a float workspace that
  the wrapper allocates. Every token resolves its own page, so any page
  size is taken. On the card ``chip_smoke.py`` holds every float32 call
  against :func:`paged_attention_reference` at atol/rtol 2e-5, two
  launches bit for bit, and a NaN key to the plain version's NaN rows.

``paged_attention`` launches the kernels for CUDA tensors and raises on
what they do not take; only CPU tensors take the plain version
``paged_attention_reference``. ``supported`` says, from shapes and dtypes
alone, whether the kernels take a call: ``paged_attention_update`` sends
what it refuses (a head_dim outside ``HEAD_DIMS``) to the plain version.
``launches`` counts wrapper calls that launched (``launches_by`` by kind and
pool type, e.g. ``("chunked", "int8")``; ``launches_by_kernel`` by the entry
of ``KERNELS`` that ran), ``plain_calls`` calls of the plain version;
all are updated under the module's ``COUNT_LOCK``, so replicas serving from
threads of one process count exactly.
"""
from __future__ import annotations

import threading

import torch

from . import _build
from .paged_attention import (_chunked_attention, _decode_attention,
                              gather_pool, is_quantized_pool)

__all__ = ["paged_attention", "paged_attention_reference", "supported",
           "kernel_for", "HEAD_DIMS", "KERNELS", "REPLACES", "SOURCE"]

HEAD_DIMS = (64, 128)
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas_paged_attention.py:259"
_KIND_CODES = {"decode": 0, "chunked": 1}

# the CUDA kernel each call runs (csrc/paged_attention.cu), by q's type: the
# tensor-core window kernel (windows) or the split-context decode kernel
# (one decode row a sequence)
KERNELS = ("paged_window_bf16", "paged_decode_split_bf16",
           "paged_window_f32", "paged_decode_split_f32")

launches = 0
launches_by = {}
launches_by_kernel = {}
plain_calls = 0
COUNT_LOCK = threading.Lock()


def kernel_for(kind: str, dtype, s: int) -> str:
    """Which of ``KERNELS`` a call of ``kind`` with q of ``dtype`` and
    ``s`` window rows runs (a decode call of several rows per sequence is a
    window of the decode mask)."""
    window, decode = KERNELS[:2] if dtype == torch.bfloat16 else KERNELS[2:]
    return decode if kind == "decode" and s == 1 else window


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
    with COUNT_LOCK:
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


def _pool_refusal(name, pool, q, page_size, h, d):
    """The kernel's pool contract: contiguous, 16-byte aligned, on q's
    device, [N, page_size, H, D] values in q's type or int8, and for int8
    f32 scales [N, page_size, H]. Returns why a pool breaks it, as
    ``(exception type, message)``, or None."""
    if is_quantized_pool(pool):
        values, scales = pool
        if values.dtype != torch.int8:
            return TypeError, f"{name} values must be int8, got {values.dtype}"
        if scales.device != q.device or scales.dtype != torch.float32:
            return TypeError, (f"{name} scales are {scales.dtype} on "
                               f"{scales.device}; the kernel takes float32 "
                               f"on {q.device}")
        if tuple(scales.shape) != (values.shape[0], page_size, h) or \
                not scales.is_contiguous():
            return ValueError, (
                f"{name} scales must be a contiguous [{values.shape[0]}, "
                f"{page_size}, {h}] pool, got {tuple(scales.shape)}")
    else:
        values = pool
        if values.dtype != q.dtype:
            return TypeError, f"{name} is {values.dtype}; q is {q.dtype}"
    if values.device != q.device:
        return TypeError, f"{name} is on {values.device}; q on {q.device}"
    if values.dim() != 4 or values.shape[1:] != (page_size, h, d) or \
            not values.is_contiguous() or values.data_ptr() % 16:
        return ValueError, (
            f"{name} must be a contiguous, 16-byte aligned [num_pages, "
            f"{page_size}, {h}, {d}] pool, got {tuple(values.shape)}")
    return None


def _refusal(q, k_pool, v_pool, block_tables, page_size, kind):
    """Why the kernel would not take this call, as ``(exception type,
    message)``, or None: decided by kind, shapes, dtypes, strides and
    alignment of q, the pools and the block table, before any launch."""
    if kind not in _KIND_CODES:
        return ValueError, (f"kind must be 'decode' or 'chunked', got "
                            f"{kind!r}")
    if q.dim() != 4 or q.stride(-1) != 1:
        return ValueError, ("q must be [B, S, H, D] with a contiguous "
                            "head_dim")
    b, _, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        return TypeError, (f"paged_attention kernel takes float32 or "
                           f"bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        return ValueError, (f"paged_attention kernel takes head_dim in "
                            f"{HEAD_DIMS}, got {d}")
    if is_quantized_pool(k_pool) != is_quantized_pool(v_pool):
        return TypeError, ("k_pool and v_pool must both be int8 tuples or "
                           "both tensors")
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        refused = _pool_refusal(name, pool, q, page_size, h, d)
        if refused is not None:
            return refused
    k_vals = k_pool[0] if is_quantized_pool(k_pool) else k_pool
    v_vals = v_pool[0] if is_quantized_pool(v_pool) else v_pool
    if k_vals.shape != v_vals.shape:
        return ValueError, "k_pool and v_pool differ in shape"
    if page_size < 1:
        return ValueError, f"page_size must be at least 1, got {page_size}"
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        return ValueError, (f"block_tables must be [{b}, P], got "
                            f"{tuple(block_tables.shape)}")
    return None


def supported(q, k_pool, v_pool, block_tables, page_size: int,
              kind: str) -> bool:
    """Does the kernel take this call? The counterpart of the reference's
    ``pallas_paged_attention.supported`` (``:69-80``): the caller
    (``paged_attention_update``) sends what it refuses — a head_dim outside
    ``HEAD_DIMS``, pools it cannot read — to the plain version, as the
    reference sends it to its gather path. Any page size of at least one
    slot is taken. The device is the wrapper's business: CPU tensors of a
    shape it takes still go through the wrapper, which runs the plain
    version there."""
    return _refusal(q, k_pool, v_pool, block_tables, page_size,
                    kind) is None


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
    refused = _refusal(q, k_pool, v_pool, block_tables, page_size, kind)
    if refused is not None:
        exc, msg = refused
        raise exc(msg)
    b, s, h, d = q.shape
    k_vals, k_sc = ((k_pool[0], k_pool[1]) if is_quantized_pool(k_pool)
                    else (k_pool, None))
    v_vals, v_sc = ((v_pool[0], v_pool[1]) if is_quantized_pool(v_pool)
                    else (v_pool, None))
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
    dtype = _build.DTYPE_CODES[str(q.dtype)]
    # the split kernels' partial softmax states
    n_work = lib.pt_paged_workspace_floats(b, s, h, d, page_size, n_tab,
                                           _KIND_CODES[kind], dtype)
    work = torch.empty(max(n_work, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_paged_attention(
            q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
            k_sc.data_ptr() if k_sc is not None else None,
            v_sc.data_ptr() if v_sc is not None else None,
            out.data_ptr(), tables.data_ptr(), ctx.data_ptr(),
            val.data_ptr(), pos.data_ptr(), b, s, h, d, k_vals.shape[0],
            page_size, n_tab, q.stride(0), q.stride(1), q.stride(2),
            float(scale), _KIND_CODES[kind], dtype,
            _build.DTYPE_CODES[str(k_vals.dtype)], work.data_ptr(),
            work.numel(), stream)
    _build.check(err, "paged_attention")
    key = (kind, str(k_vals.dtype).replace("torch.", ""))
    name = kernel_for(kind, q.dtype, s)
    with COUNT_LOCK:
        launches += 1
        launches_by[key] = launches_by.get(key, 0) + 1
        launches_by_kernel[name] = launches_by_kernel.get(name, 0) + 1
    return out
