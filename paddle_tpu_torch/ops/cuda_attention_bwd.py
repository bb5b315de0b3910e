"""Flash-attention backward: the CUDA kernels' wrapper and their plain version.

Kernels: ``csrc/flash_bwd.cu``, the port of the two TPU kernels of
``paddle_tpu/ops/pallas_attention.py::_mha_bwd``: ``flash_bwd_dq`` replaces
``_mha_bwd_dq_kernel`` (``pl.pallas_call`` at ``pallas_attention.py:288``)
and ``flash_bwd_dkv`` replaces ``_mha_bwd_dkv_kernel`` (``:313``).

- What they compute: from q, k, v, the forward's output and row logsumexp
  and the output's cotangent dO, p = exp(q kᵀ·scale − lse) recomputed per
  tile, ds = p·(dO vᵀ − δ)·scale with δ = rowsum(o·dO) − lse_ct, and
  dq = ds k, dk = dsᵀ q, dv = pᵀ dO, accumulated in float. δ is a torch
  reduction here, as the reference left it to XLA (``:281``).
- What bounds them on the H100: operations (3 and 4 products of 2·S²·D per
  head, halved when causal, against ~5·S·D elements moved).
- What their design does about it: bf16 runs every product on the tensor
  cores (``mma.sync``), float32 keeps exact float FMAs; two kernels, as the
  TPU, so no float atomics and bit-for-bit repeatable gradients;
  ``csrc/flash_bwd.cu`` has the details.

``flash_attention_bwd`` launches both kernels for CUDA tensors and raises on
what they do not take; only CPU tensors take the plain version
``mha_bwd_reference``. ``launches`` counts each kernel's launches,
``plain_calls`` the plain version's calls (it stands for both kernels), as
plain module-level dictionaries keyed by kernel name.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .cuda_attention import NEG_INF, _check

__all__ = ["flash_attention_bwd", "mha_bwd_reference", "KERNELS",
           "REPLACES", "SOURCE"]

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
SOURCE = "paddle_tpu_torch/csrc/flash_bwd.cu"
REPLACES = {"flash_bwd_dq": "paddle_tpu/ops/pallas_attention.py:288",
            "flash_bwd_dkv": "paddle_tpu/ops/pallas_attention.py:313"}

launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)


def _delta(out, do, lse_ct):
    """δ = rowsum(o·dO) in float as ``[B*H, S]`` (minus the lse
    cotangent, ``[B*H, S]`` or ``[B, H, S]``, when one is given)."""
    b, s, h, _ = out.shape
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).reshape(
        b * h, s)
    if lse_ct is not None:
        delta = delta - lse_ct.float().reshape(b * h, s)
    return delta.contiguous()


def mha_bwd_reference(q, k, v, out, lse, do, causal=True, scale=None,
                      lse_ct=None):
    """Plain PyTorch version of the two kernels, with the maths of the JAX
    reference ``_mha_bwd``: float scores from the inputs, the ``NEG_INF``
    mask (top-left aligned ``tril(k=sk-sq)``), p = exp(s − lse), and p and
    ds rounded to the input type before the products that take them, as
    the TPU kernels round them (``pallas_attention.py:204, 252, 258``).

    q/out/do: ``[B, Sq, H, D]``; k/v: ``[B, Sk, H, D]``; lse: the forward's
    ``[B*H, Sq]`` float. Returns ``(dq, dk, dv)`` in the layout and type of
    q, k, v."""
    for name in KERNELS:
        plain_calls[name] += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale       # [B,H,Sq,Sk]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.float().reshape(b, h, sq, 1))
    del s
    delta = _delta(out, do, lse_ct).reshape(b, h, sq, 1)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    del p
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _strides(*tensors):
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def flash_attention_bwd(q, k, v, out, lse, do, causal=True, scale=None,
                        lse_ct=None):
    """Flash-attention backward over ``[B, S, H, D]`` tensors (q/k/v/dO in
    any strides with a contiguous last dim; ``out`` and ``lse`` as the
    forward returned them). ``lse_ct`` is an optional cotangent on the
    forward's lse (``[B*H, Sq]`` or ``[B, H, Sq]``), folded in as δ −=
    lse_ct. Returns ``(dq, dk, dv)``, contiguous ``[B, S, H, D]`` in the
    input type. CUDA tensors launch the two kernels of
    ``csrc/flash_bwd.cu`` on the current stream (no synchronisation); CPU
    tensors take :func:`mha_bwd_reference`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                 scale=scale, lse_ct=lse_ct)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, got "
                         f"{q.device}")
    _check(q, k, v, causal)
    _check(do, k, v, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must match q {tuple(q.shape)}")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous [B*H, Sq] "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    delta = _delta(out, do, lse_ct)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if b * h * sq == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _build.load_library()
    strides = _strides(q, k, v, do)
    tail = (b, h, sq, sk, d, strides, float(scale), int(bool(causal)),
            _build.DTYPE_CODES[str(q.dtype)])
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_bwd_dq(*ins, dq.data_ptr(), *tail, stream)
        _build.check(err, "flash_bwd_dq")
        launches["flash_bwd_dq"] += 1
        err = lib.pt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail,
                                   stream)
        _build.check(err, "flash_bwd_dkv")
        launches["flash_bwd_dkv"] += 1
    return dq, dk, dv
