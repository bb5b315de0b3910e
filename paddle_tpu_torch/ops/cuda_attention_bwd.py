"""Flash-attention backward: the CUDA kernels' wrapper and their plain version.

Kernels: ``csrc/flash_bwd.cu``, the port of the two TPU kernels of
``paddle_tpu/ops/pallas_attention.py::_mha_bwd``: ``flash_bwd_dq`` replaces
``_mha_bwd_dq_kernel`` (``:162``, ``pl.pallas_call`` at
``pallas_attention.py:288``) and ``flash_bwd_dkv`` replaces
``_mha_bwd_dkv_kernel`` (``:212``, call ``:313``).

- What they compute: from q, k, v, the forward's output and row logsumexp
  and the output's cotangent dO, p = exp(q kᵀ·scale − lse) recomputed per
  tile, ds = p·(dO vᵀ − δ)·scale with δ = rowsum(o·dO) − lse_ct, and
  dq = ds k, dk = dsᵀ q, dv = pᵀ dO, accumulated in float (p and ds rounded
  to the input type, bf16 or float16, before the products that take them,
  as the reference rounds them; in float16 an overflow becomes inf and is
  not clamped, so a scaled loss's overflow reaches the gradients as the
  reference's does). δ is a torch reduction here, as the reference left it
  to XLA (``:281``). For the float32 kernels the wrapper also takes each
  (batch, head)'s mean key and value out of K and V first (``_centered``),
  which leaves the gradients as they are and keeps dq's rounding at
  float32's own where a shared part of the keys cancels.
- What bounds them on the H100: operations (3 and 4 products of 2·S²·D per
  head, halved when causal, against ~5·S·D elements moved); in bf16 and
  float16 only ``wgmma`` reaches the tensor cores' dense rate.
- What their design does about it: bf16 and float16 run two
  warp-specialised Hopper
  kernels shaped like the forward. A block owns 128 rows (queries for dq,
  keys for dk/dv), loaded once by TMA; a producer warpgroup streams the
  other side's 64-row tiles through a three-stage ``mbarrier`` ring (dk/dv
  with their lse and δ); two consumer warpgroups run every product with
  ``wgmma`` straight from the tiles TMA wrote, the transposed operands read
  through the descriptors' transpose bit (no transposed copy), p and ds
  built in registers as the next product's operand. The tensor maps are
  encoded per call; a map the driver refuses raises. float32 runs every
  product on tensor cores in 3xTF32 (``mma.sync``; each operand split into
  TF32 hi + lo parts, three products, float accumulators joined one short
  sum at a time: float32 accuracy, where one TF32 product would keep ~11
  bits): blocks of 64 rows (128 at head_dim 128), the other side's tiles
  of 32 rows (dk/dv's of 64 at head_dim 64) in a two-stage ``cp.async``
  ring (16-byte copies: a float32 view whose rows are not 16-byte aligned
  is copied first), p and ds in registers. Two kernels, as
  the TPU, so no float atomics and bit-for-bit repeatable gradients;
  ``csrc/flash_bwd.cu`` has the details, ``csrc/tf32.cuh`` the 3xTF32
  pieces.

``flash_attention_bwd`` launches both kernels for CUDA tensors and raises on
what they do not take; only CPU tensors take the plain version
``mha_bwd_reference``. ``launches`` counts each kernel's launches,
``plain_calls`` the plain version's calls (it stands for both kernels), as
plain module-level dictionaries keyed by kernel name (updated under the
module's ``COUNT_LOCK``, so threads of one process count exactly), and
``flops`` the operations of the launched kernels' matrix products over the
whole score matrix (dq three products, ``6·B·H·Sq·Sk·D``; dk/dv four,
``8·B·H·Sq·Sk·D``; a causal launch skips the tiles its mask empties),
which a FLOP counter over torch's ops cannot see, and ``bytes_moved`` the
bytes of both kernels' operands and results.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build
from .cuda_attention import HALF_DTYPES, NEG_INF, _check, _rows_aligned

__all__ = ["flash_attention_bwd", "mha_bwd_reference", "KERNELS",
           "REPLACES", "SOURCE"]

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
SOURCE = "paddle_tpu_torch/csrc/flash_bwd.cu"
REPLACES = {"flash_bwd_dq": "paddle_tpu/ops/pallas_attention.py:288",
            "flash_bwd_dkv": "paddle_tpu/ops/pallas_attention.py:313"}

launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)
flops = dict.fromkeys(KERNELS, 0.0)
bytes_moved = 0.0
COUNT_LOCK = threading.Lock()
# the products of each kernel (s, dp, dq; s, dp, dv, dk)
_PRODUCTS = {"flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def _delta(out, do, lse_ct):
    """δ = rowsum(o·dO) in float as ``[B*H, S]`` (minus the lse
    cotangent, ``[B*H, S]`` or ``[B, H, S]``, when one is given)."""
    b, s, h, _ = out.shape
    # dO is widened inside the product's kernel (no float copy of it)
    delta = (out.float() * do).sum(-1).transpose(1, 2).reshape(b * h, s)
    if lse_ct is not None:
        delta = delta - lse_ct.float().reshape(b * h, s)
    return delta.contiguous()


def _centered(q, k, v, out, lse, do, lse_ct, scale):
    """The float32 kernels' operands: K and V less their mean over the keys
    of each (batch, head), ``ck`` and ``cv``, with the lse and δ that keep
    p and dS as they were: lse − scale·q·ck and rowsum((o − cv)·dO), less
    the lse cotangent. Returns ``(k, v, lse, delta, ck)``.

    dQ = Σ p (dp − δ) k: where the keys share a large part (deep layers of
    a model put one in every token) and attention is near-uniform, dQ is a
    small residue of that shared part, and the rounding of dp, δ and the
    products, against the large k and v, leaves a term (Σ p dp − δ)·Σ p k
    of the shared k's size. A row of p sums to 1 and a row of dS to
    scale·lse_ct, so a shift of V changes no dp − δ and a shift of K adds
    scale·lse_ct·ck to dQ (added back by the caller) and changes nothing
    else; without the shared parts the rounding is that of the residue
    itself. A mean that is not finite (an inf or NaN key) is not
    subtracted."""
    b, sq, h, _ = q.shape
    ck = k.mean(1, keepdim=True).nan_to_num(0.0, 0.0, 0.0)   # [B, 1, H, D]
    cv = v.mean(1, keepdim=True).nan_to_num(0.0, 0.0, 0.0)
    shift = (q * ck).sum(-1).transpose(1, 2).reshape(b * h, sq) * scale
    return (k - ck, v - cv, (lse - shift).contiguous(),
            _delta(out - cv, do, lse_ct), ck)


def _lse_ct_term(dq, lse_ct, ck, scale):
    """dQ's part that the shift of K by ``ck`` took out: scale·lse_ct·ck,
    added to ``dq`` ``[B, Sq, H, D]`` in place."""
    b, sq, h, _ = dq.shape
    ct = lse_ct.float().reshape(b, h, sq).transpose(1, 2)[..., None]
    dq.add_(ct * ck * scale)


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
    with COUNT_LOCK:
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


def _check_bwd(q, k, v, out, lse, do, causal):
    """What the kernels take, beyond ``_check`` of q/k/v (which also holds
    dq's grid, one block per 128 query rows, and dk/dv's, one per 128 keys,
    to 2^31 - 1 blocks) and of dO against k/v."""
    _check(q, k, v, causal, backward=True)
    if do.dtype in HALF_DTYPES and (
            do.data_ptr() % 16 or any(st % 8 for st in do.stride()[:3])):
        raise ValueError("dO: the 16-bit kernels need 16-byte aligned rows "
                         "(pointer and b/s/h strides)")
    _check(do, k, v, causal)
    b, sq, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must match q {tuple(q.shape)}")
    if q.dtype in HALF_DTYPES:
        # dk/dv's lse tiles come by TMA, from a 16-byte aligned base
        if lse.data_ptr() % 16:
            raise ValueError("lse: the 16-bit kernels need a 16-byte aligned "
                             "base pointer")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous [B*H, Sq] "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd(q, k, v, out, lse, do, causal=True, scale=None,
                        lse_ct=None):
    """Flash-attention backward over ``[B, S, H, D]`` tensors (q/k/v/dO in
    any strides with a contiguous last dim; ``out`` and ``lse`` as the
    forward returned them). ``lse_ct`` is an optional cotangent on the
    forward's lse (``[B*H, Sq]`` or ``[B, H, Sq]``), folded in as δ −=
    lse_ct. Returns ``(dq, dk, dv)``, contiguous ``[B, S, H, D]`` in the
    input type. CUDA tensors launch the two kernels of
    ``csrc/flash_bwd.cu`` on the current stream (no synchronisation; in
    float32 on the operands of :func:`_centered`); CPU tensors take
    :func:`mha_bwd_reference`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                 scale=scale, lse_ct=lse_ct)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, got "
                         f"{q.device}")
    _check_bwd(q, k, v, out, lse, do, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    ck = None
    if q.dtype == torch.float32:
        k, v, lse, delta, ck = _centered(q, k, v, out, lse, do, lse_ct,
                                         scale)
    else:
        delta = _delta(out, do, lse_ct)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if b * h * sq == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(lib, stream, q, k, v, do, lse, delta, dq, dk, dv, causal,
                scale)
        if ck is not None and lse_ct is not None:
            _lse_ct_term(dq, lse_ct, ck, scale)
    moved = float(sum(t.numel() * t.element_size()
                      for t in (q, k, v, do, lse, delta, dq, dk, dv)))
    global bytes_moved
    with COUNT_LOCK:
        for name, n in _PRODUCTS.items():
            flops[name] += 2.0 * n * b * h * sq * sk * d
        bytes_moved += moved
    return dq, dk, dv


def _pad_rows(t, n):
    """``t`` ``[B, S, H, D]`` with zero rows appended up to S = n."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - t.shape[1]))


def _launch(lib, stream, q, k, v, do, lse, delta, dq, dk, dv, causal,
            scale):
    """Launch the two kernels of ``lib`` on ``stream`` (dq, then dk/dv) and
    count them. float32 rows that are not 16-byte aligned are copied first:
    the float32 kernels load rows with 16-byte ``cp.async`` copies, and the
    C entry points refuse such a view.

    The 16-bit dk/dv kernel loads each (batch, head)'s lse and δ rows by
    1-D TMA from ``bh · Sq + q0``, a start that must be 16-byte aligned: Sq
    a multiple of 4. Otherwise (and more than one (batch, head)) q and dO
    (and, causal, k and v) get zero rows up to the next multiple of 4, lse
    and δ zeros: a zero query row with a zero dO adds nothing to dk or dv,
    and the real rows' causal windows never reach a padded key. The padded
    gradients' real rows are copied out."""
    if q.dtype == torch.float32:
        q, k, v, do = (_rows_aligned(t) for t in (q, k, v, do))
    b, sq, h, d = q.shape
    if q.dtype in HALF_DTYPES and sq % 4 and b * h > 1:
        sp = sq + (-sq) % 4
        q, do = _pad_rows(q, sp), _pad_rows(do, sp)
        lse = torch.nn.functional.pad(lse.reshape(b * h, sq), (0, sp - sq))
        delta = torch.nn.functional.pad(delta.reshape(b * h, sq),
                                        (0, sp - sq))
        dq_p = torch.empty_like(q)
        if causal:
            k, v = _pad_rows(k, sp), _pad_rows(v, sp)
            dk_p, dv_p = torch.empty_like(k), torch.empty_like(v)
        else:
            dk_p, dv_p = dk, dv
        _launch(lib, stream, q, k, v, do, lse, delta, dq_p, dk_p, dv_p,
                causal, scale)
        dq.copy_(dq_p[:, :sq])
        if causal:
            dk.copy_(dk_p[:, :sq])
            dv.copy_(dv_p[:, :sq])
        return
    strides = _strides(q, k, v, do)
    tail = (b, h, sq, k.shape[1], d, strides, float(scale),
            int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)])
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    err = lib.pt_flash_bwd_dq(*ins, dq.data_ptr(), *tail, stream)
    _build.check(err, "flash_bwd_dq")
    with COUNT_LOCK:
        launches["flash_bwd_dq"] += 1
    err = lib.pt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail,
                               stream)
    _build.check(err, "flash_bwd_dkv")
    with COUNT_LOCK:
        launches["flash_bwd_dkv"] += 1
