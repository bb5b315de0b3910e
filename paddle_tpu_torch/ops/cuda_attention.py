"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Kernel: ``csrc/flash_fwd.cu``, the port of the TPU kernel
``paddle_tpu/ops/pallas_attention.py::_mha_fwd`` (body ``_mha_fwd_kernel``,
``pl.pallas_call`` at ``pallas_attention.py:135``).

- What it computes: causal (top-left aligned, ``sq == sk``) or full softmax
  attention with an online softmax in float, returning ``out`` and the row
  logsumexp ``lse`` (``[B*H, S]`` float; the TPU kept it 128-lane
  replicated).
- What bounds it on the H100: at prefill and training widths it is bound
  by operations (``4*S^2*D/2`` flops per head against ``4*S*D`` elements
  moved); in bf16 and float16 only ``wgmma`` reaches the tensor cores'
  dense rate; in float32 the tensor cores take TF32, three products for
  each float32 product (495 / 3 TFLOP/s, against 67 for float FMAs).
- What its design does about it: bf16 and float16 (one template over the
  element type) run a warp-specialised Hopper
  kernel. A producer warpgroup loads Q once and K/V tiles of 128 keys by
  TMA into a two-stage ``mbarrier`` ring (128-byte swizzled shared memory;
  the tensor maps are encoded per call from the tensors' pointers and
  strides). Two consumer warpgroups, 64 query rows each, run S = Q K^T and
  O += P V with ``wgmma`` (P from registers, V read MN-major from its TMA
  tile) and the online softmax in registers. Only tiles on the causal
  diagonal or the ragged end build a mask, and the heaviest causal blocks
  start first. float32 runs both products on tensor cores in 3xTF32
  (``mma.sync``; each operand split into TF32 hi + lo parts, three
  products, float accumulators: float32 accuracy, where one TF32 product
  would keep ~11 bits), blocks of 128 query rows at D=64 and 64 at
  D=128, 32-key K/V tiles in a two-stage ``cp.async`` ring (16-byte
  copies: a float32 view whose rows are not 16-byte aligned is copied
  first) and the softmax in registers. Causal tiles stop at the
  diagonal and ragged edges are masked, so any ``S`` runs
  (``csrc/flash_fwd.cu`` has the details, ``csrc/hopper.cuh`` the TMA,
  ``mbarrier`` and ``wgmma`` pieces).

``flash_attention_fwd`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; only CPU tensors take the plain version
``mha_fwd_reference``. ``supported`` says, from shapes, dtype and strides
alone, whether the kernel takes a call: the callers
(``ops/flash_attention.py``) send what it refuses to the plain version.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version (both plain module-level integers, incremented under the module's
``COUNT_LOCK``, so replicas serving from threads of one process count
exactly), and ``flops`` the operations
of the launched kernels' two matrix products, ``4·B·H·Sq·Sk·D`` a launch
over the whole score matrix (a causal launch skips the tiles its mask
empties): a FLOP counter over torch's ops (``bench.py``'s cost check)
cannot see a kernel called through ``ctypes``; ``bytes_moved`` the bytes of
the launched kernels' operands and results (q, k, v, out, lse), which the
observability plane's byte count adds for the same reason.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _build

__all__ = ["flash_attention_fwd", "mha_fwd_reference", "supported",
           "HEAD_DIMS", "HALF_DTYPES", "NEG_INF", "REPLACES", "SOURCE"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# the 16-bit types, which take the tensor-core (TMA + wgmma) kernels
HALF_DTYPES = (torch.bfloat16, torch.float16)
SOURCE = "paddle_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "paddle_tpu/ops/pallas_attention.py:135"

launches = 0
plain_calls = 0
flops = 0.0
bytes_moved = 0.0
COUNT_LOCK = threading.Lock()


def mha_fwd_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of the kernel: float scores, the ``NEG_INF``
    mask (top-left aligned ``tril(k=sk-sq)``), p = exp(s - row max) rounded
    to v's type before the float product with v (as the TPU kernel rounds
    it, ``pallas_attention.py:104``, and the reference's dense path its
    probabilities, ``paddle_tpu/ops/flash_attention.py:207-208``; a no-op in
    float32, where this is ``_mha_reference``'s maths), divided by the row
    sum of the unrounded p, cast to q's type; plus the row logsumexp. The
    backward's plain version rounds p and ds the same way.

    q: ``[B, Sq, H, D]``; k/v: ``[B, Sk, H, D]``. Returns
    ``(out [B, Sq, H, D] in q.dtype, lse [B*H, Sq] float32)``.
    """
    global plain_calls
    with COUNT_LOCK:
        plain_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # [B,H,Sq,Sk]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    del logits
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l)).reshape(b * h, sq)
    out = torch.matmul(p.to(v.dtype).float(), vf) / l
    return out.transpose(1, 2).to(q.dtype), lse


def _refusal(q, k, v, causal, backward=False):
    """Why the kernel would not take these tensors, as ``(exception type,
    message)``, or None when it takes them. Decided by shape, dtype, strides
    and alignment alone, before any launch. ``backward`` adds what the two
    backward kernels need beyond the forward (dk/dv's grid over the keys)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            return ValueError, f"{name} is on {t.device}, q on {q.device}"
        if t.dtype != q.dtype:
            return TypeError, f"{name} is {t.dtype}, q is {q.dtype}"
        if t.dim() != 4:
            return ValueError, (f"{name} must be [B, S, H, D], got "
                                f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            return ValueError, (f"{name}'s head_dim must be contiguous "
                                f"(stride {t.stride(-1)})")
    if q.dtype not in (torch.float32, *HALF_DTYPES):
        return TypeError, (f"flash_fwd kernel takes float32, bfloat16 or "
                           f"float16, got {q.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        return ValueError, (f"flash_fwd kernel takes head_dim in "
                            f"{HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        return ValueError, (f"k/v shapes {tuple(k.shape)}/"
                            f"{tuple(v.shape)} do not match q "
                            f"{tuple(q.shape)}")
    sk = k.shape[1]
    if sk < 1:
        return ValueError, "flash_fwd needs at least one key"
    if causal and sk != sq:
        return ValueError, (f"causal attention masks top-left aligned "
                            f"windows only: sq={sq} != sk={sk}")
    if q.dtype in HALF_DTYPES:
        # TMA takes a 16-byte aligned base and strides of whole 16 bytes
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                return ValueError, (f"{name}: the 16-bit kernel needs "
                                    f"16-byte aligned rows (pointer and "
                                    f"b/s/h strides)")
        # one block per 128 query rows of a (batch, head), on a 1-D grid
        if b * h * -(-sq // 128) > 2**31 - 1:
            return ValueError, (f"flash_fwd 16-bit kernel takes at most "
                                f"2^31 - 1 blocks of 128 rows, got B={b} "
                                f"H={h} S={sq}")
        # dk/dv: one block per 128 keys, on a 1-D grid
        if backward and b * h * -(-sk // 128) > 2**31 - 1:
            return ValueError, (f"flash_bwd_dkv 16-bit kernel takes at most "
                                f"2^31 - 1 blocks of 128 keys, got B={b} "
                                f"H={h} Sk={sk}")
    return None


def _check(q, k, v, causal, backward=False):
    """Raise on what the forward kernel (with ``backward``, also the two
    backward kernels) does not take."""
    refused = _refusal(q, k, v, causal, backward=backward)
    if refused is not None:
        exc, msg = refused
        raise exc(msg)


def supported(q, k, v, causal=True, backward=False) -> bool:
    """Does the flash kernel take this call (and, with ``backward``, do the
    two backward kernels take its gradient)? The counterpart of the
    reference's ``flash_attention.supported``: callers send what it refuses
    (a head_dim outside ``HEAD_DIMS``, another dtype, unaligned 16-bit
    rows)
    to the plain version, as the reference sends it to its dense path. The
    device is the wrapper's business: CPU tensors of a shape it takes still
    go through the wrapper, which runs the plain version there."""
    return _refusal(q, k, v, causal, backward=backward) is None


def _rows_aligned(t):
    """``t``, or a contiguous copy when its rows are not 16-byte aligned
    (pointer or b/s/h strides): the float32 kernel loads rows with 16-byte
    ``cp.async`` copies."""
    if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """Flash-attention forward over ``[B, S, H, D]`` tensors (any strides
    with a contiguous last dim). Returns ``(out [B, Sq, H, D],
    lse [B*H, Sq] float32)``. CUDA tensors launch ``csrc/flash_fwd.cu`` on
    the current stream (no synchronisation); CPU tensors take
    :func:`mha_fwd_reference`."""
    global launches, flops, bytes_moved
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_fwd_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, got "
                         f"{q.device}")
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    if q.dtype == torch.float32:
        q, k, v = (_rows_aligned(t) for t in (q, k, v))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
            stream)
    _build.check(err, "flash_fwd")
    with COUNT_LOCK:
        launches += 1
        flops += 4.0 * b * h * sq * sk * d
        bytes_moved += float(sum(t.numel() * t.element_size()
                                 for t in (q, k, v, out, lse)))
    return out, lse
