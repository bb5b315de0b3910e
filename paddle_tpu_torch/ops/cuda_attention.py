"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Kernel: ``csrc/flash_fwd.cu``, the port of the TPU kernel
``paddle_tpu/ops/pallas_attention.py::_mha_fwd`` (body ``_mha_fwd_kernel``,
``pl.pallas_call`` at ``pallas_attention.py:135``).

- What it computes: causal (top-left aligned, ``sq == sk``) or full softmax
  attention with an online softmax in float, returning ``out`` and the row
  logsumexp ``lse`` (``[B*H, S]`` float; the TPU kept it 128-lane
  replicated).
- What bounds it on the H100: at prefill widths it is bound by operations
  (``4*S^2*D/2`` flops per head against ``4*S*D`` elements moved).
- What its design does about it: bf16 runs both products on the tensor
  cores (``mma.sync`` m16n8k16, FlashAttention-2 register layout: scores,
  probabilities and the output accumulator stay in registers); float32
  uses float FMAs over 64x64 tiles in shared memory, which keeps float32
  exact. Causal tiles stop at the diagonal and ragged edges are masked, so
  any ``S`` runs (``csrc/flash_fwd.cu`` has the details). ``wgmma``/TMA
  are later work.

``flash_attention_fwd`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; only CPU tensors take the plain version
``mha_fwd_reference``. ``launches`` counts kernel launches, ``plain_calls``
calls of the plain version (both plain module-level integers).
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention_fwd", "mha_fwd_reference", "HEAD_DIMS",
           "NEG_INF", "REPLACES", "SOURCE"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
SOURCE = "paddle_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "paddle_tpu/ops/pallas_attention.py:135"

launches = 0
plain_calls = 0


def mha_fwd_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of the kernel, with the maths of the JAX
    reference ``_mha_reference`` (``pallas_attention.py:350``): float
    scores, ``NEG_INF`` mask (top-left aligned ``tril(k=sk-sq)``), softmax,
    float product with v, cast to q's type; plus the row logsumexp.

    q: ``[B, Sq, H, D]``; k/v: ``[B, Sk, H, D]``. Returns
    ``(out [B, Sq, H, D] in q.dtype, lse [B*H, Sq] float32)``.
    """
    global plain_calls
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
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, sq)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype), lse


def _check(q, k, v, causal):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous "
                             f"(stride {t.stride(-1)})")
    if str(q.dtype) not in _build.DTYPE_CODES:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash_fwd needs at least one key")
    if causal and k.shape[1] != sq:
        raise ValueError(f"causal attention masks top-left aligned windows "
                         f"only: sq={sq} != sk={k.shape[1]}")
    if q.dtype == torch.bfloat16:
        # the tensor-core path loads rows as 16-byte vectors
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"{name}: the bf16 kernel needs 16-byte "
                                 f"aligned rows (pointer and b/s/h strides)")


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """Flash-attention forward over ``[B, S, H, D]`` tensors (any strides
    with a contiguous last dim). Returns ``(out [B, Sq, H, D],
    lse [B*H, Sq] float32)``. CUDA tensors launch ``csrc/flash_fwd.cu`` on
    the current stream (no synchronisation); CPU tensors take
    :func:`mha_fwd_reference`."""
    global launches
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
    launches += 1
    return out, lse
