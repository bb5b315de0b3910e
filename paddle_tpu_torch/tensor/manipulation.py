"""Shape and layout ops: the port of ``paddle_tpu/tensor/manipulation.py``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from .math import _inplace

slice_builtin = slice  # the builtin, before the `slice` op shadows it


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.numpy().tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _int(v) -> int:
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def reshape(x, shape, name=None):
    s = _shape_list(shape)
    return apply_op("reshape", lambda a: torch.reshape(a, s), x)


def reshape_(x, shape, name=None):
    return _inplace(x, reshape(x, shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        nd = a.dim()
        if nd == 0:
            return a.reshape(1)
        st, sp = start_axis % nd, stop_axis % nd
        return a.reshape(list(a.shape[:st]) + [-1] + list(a.shape[sp + 1:]))
    return apply_op("flatten", fn, x)


def transpose(x, perm, name=None):
    return apply_op("transpose", lambda a: a.permute(*[int(p) for p in perm]),
                    x)


transpose_ = transpose


def moveaxis(x, source, destination, name=None):
    return apply_op("moveaxis", lambda a: torch.movedim(a, source,
                                                        destination), x)


def swapaxes(x, axis1, axis2, name=None):
    return apply_op("swapaxes", lambda a: torch.swapaxes(a, axis1, axis2), x)


def unsqueeze(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]

    def fn(a):
        out = a
        for i in sorted(_int(v) for v in ax):
            out = out.unsqueeze(i)
        return out
    return apply_op("unsqueeze", fn, x)


def squeeze(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return a.squeeze()
        ax = axis if isinstance(axis, (list, tuple)) else [axis]
        ax = tuple(sorted({_int(v) % a.dim() for v in ax
                           if a.shape[_int(v) % a.dim()] == 1}))
        return a.squeeze(ax) if ax else a
    return apply_op("squeeze", fn, x)


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis))


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply_op("concat", lambda *xs: torch.cat(xs, axis), *x)


def stack(x, axis=0, name=None):
    return apply_op("stack", lambda *xs: torch.stack(xs, axis), *x)


def hstack(x, name=None):
    return apply_op("hstack", lambda *xs: torch.hstack(xs), *x)


def vstack(x, name=None):
    return apply_op("vstack", lambda *xs: torch.vstack(xs), *x)


def dstack(x, name=None):
    return apply_op("dstack", lambda *xs: torch.dstack(xs), *x)


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)

    def fn(a):
        total = a.shape[axis]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"split: {total} is not divisible by "
                                 f"{num_or_sections}")
            return tuple(torch.split(a, total // num_or_sections, axis))
        secs = [_int(s) for s in num_or_sections]
        known = sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
        return tuple(torch.split(a, secs, axis))
    return list(apply_op("split", fn, x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis, name)


def unbind(x, axis=0, name=None):
    return list(apply_op("unbind", lambda a: torch.unbind(a, axis), x))


def tile(x, repeat_times, name=None):
    reps = _shape_list(repeat_times)
    return apply_op("tile", lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    s = _shape_list(shape)

    def fn(a):
        offset = len(s) - a.dim()
        full = [(a.shape[i - offset] if i >= offset else 1) if v == -1
                else v for i, v in enumerate(s)]
        return torch.broadcast_to(a, full)
    return apply_op("expand", fn, x)


def expand_as(x, y, name=None):
    return apply_op("expand_as", lambda a, b: torch.broadcast_to(a, b.shape),
                    x, y)


def broadcast_to(x, shape, name=None):
    s = _shape_list(shape)
    return apply_op("broadcast_to", lambda a: torch.broadcast_to(a, s), x)


def broadcast_tensors(inputs, name=None):
    return list(apply_op("broadcast_tensors", lambda *xs: tuple(
        torch.broadcast_tensors(*xs)), *inputs))


def flip(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply_op("flip", lambda a: torch.flip(a, [int(v) for v in ax]), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op("rot90", lambda a: torch.rot90(a, k, list(axes)), x)


def roll(x, shifts, axis=None, name=None):
    return apply_op("roll", lambda a: torch.roll(a, shifts, axis), x)


def slice(x, axes, starts, ends):  # noqa: A001
    axes = [int(a) for a in axes]
    starts = [_int(s) for s in starts]
    ends = [_int(e) for e in ends]

    def fn(a):
        idx = [slice_builtin(None)] * a.dim()
        for ax, st, en in zip(axes, starts, ends):
            idx[ax] = slice_builtin(st, en)
        return a[tuple(idx)]
    return apply_op("slice", fn, x)


def _py_slice(a, ax, st, en, sd):
    """``a`` along ``ax`` as Python's ``[st:en:sd]`` (negative steps
    too)."""
    n = a.shape[ax]
    idx = list(range(n))[slice_builtin(st, en, sd)]
    return torch.index_select(a, ax, torch.as_tensor(idx, dtype=torch.long,
                                                     device=a.device))


def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(a):
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            a = _py_slice(a, int(ax), _int(st), _int(en), _int(sd))
        return a
    return apply_op("strided_slice", fn, x)


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    return apply_op("gather", lambda a, i: torch.index_select(
        a, axis, i.reshape(-1).long()), x, index)


def gather_nd(x, index, name=None):
    def fn(a, i):
        return a[tuple(torch.movedim(i.long(), -1, 0))]
    return apply_op("gather_nd", fn, x, index)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_op("take_along_axis", lambda a, i: torch.take_along_dim(
        a, i.long(), axis), arr, indices)


def _scatter_along(a, i, v, axis, mode):
    i = i.long()
    if mode == "set":
        return torch.scatter(a, axis, i, v)
    if mode == "add":
        return torch.scatter_add(a, axis, i, v)
    return torch.scatter_reduce(a, axis, i, v, "prod")


def put_along_axis(arr, indices, values, axis, reduce="assign",  # noqa: A002
                   name=None):
    modes = {"assign": "set", "add": "add", "multiply": "mul", "mul": "mul"}
    if reduce not in modes:
        raise ValueError(f"unknown reduce {reduce}")

    def fn(a, i, v):
        v = torch.broadcast_to(torch.as_tensor(v, dtype=a.dtype,
                                               device=a.device), i.shape)
        return _scatter_along(a, i, v.contiguous(), axis, modes[reduce])
    return apply_op("put_along_axis", fn, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, i, u):
        i = (i.reshape(-1).long(),)
        if overwrite:
            return torch.index_put(a, i, u)
        base = torch.index_put(a, i, torch.zeros_like(u))
        return torch.index_put(base, i, u, accumulate=True)
    return apply_op("scatter", fn, x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    s = _shape_list(shape)

    def fn(i, u):
        out = torch.zeros(s, dtype=u.dtype, device=u.device)
        return torch.index_put(out, tuple(torch.movedim(i.long(), -1, 0)), u,
                               accumulate=True)
    return apply_op("scatter_nd", fn, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    def fn(a, i, u):
        return torch.index_put(a, tuple(torch.movedim(i.long(), -1, 0)), u,
                               accumulate=True)
    return apply_op("scatter_nd_add", fn, x, index, updates)


def index_select(x, index, axis=0, name=None):
    return apply_op("index_select", lambda a, i: torch.index_select(
        a, axis, i.reshape(-1).long()), x, index)


def index_sample(x, index, name=None):
    return apply_op("index_sample", lambda a, i: torch.take_along_dim(
        a, i.long(), 1), x, index)


def index_add(x, index, axis, value, name=None):
    return apply_op("index_add", lambda a, i, v: torch.index_add(
        a, axis, i.reshape(-1).long(), v), x, index, value)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _inplace(x, flatten(x, start_axis, stop_axis))


def put_along_axis_(arr, indices, values, axis, reduce="assign",  # noqa: A002
                    name=None):
    return _inplace(arr, put_along_axis(arr, indices, values, axis, reduce))


def index_add_(x, index, axis, value, name=None):
    return _inplace(x, index_add(x, index, axis, value))


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(a, v, *idx):
        return torch.index_put(a, tuple(i.long() if not i.dtype == torch.bool
                                        else i for i in idx),
                               torch.as_tensor(v, dtype=a.dtype,
                                               device=a.device),
                               accumulate=accumulate)
    return apply_op("index_put", fn, x, value, *indices)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply_op("repeat_interleave", lambda a, r: torch.repeat_interleave(
        a, r, dim=axis), x, repeats)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    def fn(a):
        padding = [_int(p) for p in pad]
        if len(padding) == 2 * a.dim():
            pairs = [(padding[2 * i], padding[2 * i + 1])
                     for i in range(a.dim())]
        else:
            n_sp = len(padding) // 2
            sp = [(padding[2 * i], padding[2 * i + 1]) for i in range(n_sp)]
            if data_format.startswith("NC"):
                pairs = [(0, 0)] * (a.dim() - n_sp) + list(reversed(sp))
            else:
                pairs = [(0, 0)] + list(reversed(sp)) + [(0, 0)]
        if mode == "constant":
            flat = [v for pr in reversed(pairs) for v in pr]
            return TF.pad(a, flat, mode="constant", value=value)
        # torch pads the trailing dims of a batched tensor; move the padded
        # dims there
        padded = [d for d, pr in enumerate(pairs) if pr != (0, 0)]
        rest = [d for d in range(a.dim()) if d not in padded]
        perm = rest + padded
        t = a.permute(perm)
        lead = t.shape[:len(rest)]
        t = t.reshape((1, -1) + tuple(t.shape[len(rest):]))
        flat = [v for d in reversed(padded) for v in pairs[d]]
        t = TF.pad(t, flat, mode={"reflect": "reflect",
                                  "replicate": "replicate",
                                  "circular": "circular"}[mode])
        t = t.reshape(tuple(lead) + tuple(t.shape[2:]))
        return t.permute(list(np.argsort(perm)))
    return apply_op("pad", fn, x)


def cast(x, dtype):
    tdt = dtype_mod.to_torch_dtype(dtype)
    return apply_op("cast", lambda a: a.to(tdt), x)


def cast_(x, dtype):
    return _inplace(x, cast(x, dtype))


def astype(x, dtype):
    return cast(x, dtype)


def crop(x, shape=None, offsets=None, name=None):
    s = _shape_list(shape)
    offs = [_int(o) for o in (offsets or [0] * len(s))]

    def fn(a):
        return a[tuple(slice_builtin(o, o + (d if d != -1 else a.shape[i]
                                             - o))
                       for i, (o, d) in enumerate(zip(offs, s)))]
    return apply_op("crop", fn, x)


def _host(t) -> np.ndarray:
    return t.numpy() if isinstance(t, Tensor) else np.asarray(t)


def _on(x, arr) -> Tensor:
    dev = x._data.device if isinstance(x, Tensor) else None
    return Tensor(torch.from_numpy(np.array(arr)).to(dev))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Data-dependent shape: computed on the host, as the reference."""
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _on(x, res)
    ndt = dtype_mod.convert_dtype(dtype).np_dtype
    return tuple([_on(x, res[0])] +
                 [_on(x, e.reshape(-1).astype(ndt)) for e in res[1:]])


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    arr = _host(x)
    if axis is None:
        arr, ax = arr.reshape(-1), 0
    else:
        ax = axis
    take = np.ones(arr.shape[ax], dtype=bool)
    hi = [slice_builtin(None)] * arr.ndim
    lo = list(hi)
    hi[ax], lo[ax] = slice_builtin(1, None), slice_builtin(None, -1)
    neq = arr[tuple(hi)] != arr[tuple(lo)]
    if arr.ndim > 1:
        neq = np.any(neq, axis=tuple(i for i in range(arr.ndim) if i != ax))
    take[1:] = neq
    outs = [_on(x, np.compress(take, arr, axis=ax))]
    if return_inverse:
        outs.append(_on(x, (np.cumsum(take) - 1).astype(np.int64)))
    if return_counts:
        idx = np.flatnonzero(take)
        outs.append(_on(x, np.diff(np.append(idx, arr.shape[ax])).astype(
            np.int64)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def masked_select(x, mask, name=None):
    return apply_op("masked_select", lambda a, m: torch.masked_select(
        a, m.bool()), x, mask)


def masked_fill(x, mask, value, name=None):
    def fn(a, m, v):
        return torch.where(m.bool(), torch.as_tensor(v, dtype=a.dtype,
                                                     device=a.device), a)
    return apply_op("masked_fill", fn, x, mask, value)


def masked_fill_(x, mask, value, name=None):
    return _inplace(x, masked_fill(x, mask, value))


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    def fn(a):
        n = min(a.shape[-2], a.shape[-1])
        i = torch.arange(n - abs(offset) if offset else n, device=a.device)
        r, c = i + max(-offset, 0), i + max(offset, 0)
        out = a.clone()
        out[..., r, c] = value
        return out
    return _inplace(x, apply_op("fill_diagonal", fn, x))


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    def fn(i):
        size = (index_num + nshards - 1) // nshards
        lo = shard_id * size
        inside = (i >= lo) & (i < lo + size)
        return torch.where(inside, i - lo, torch.full_like(i, ignore_value))
    return apply_op("shard_index", fn, input)


def as_complex(x, name=None):
    return apply_op("as_complex", lambda a: torch.complex(a[..., 0],
                                                          a[..., 1]), x)


def as_real(x, name=None):
    return apply_op("as_real", lambda a: torch.stack(
        [torch.real(a), torch.imag(a)], -1), x)


def tensordot(x, y, axes=2, name=None):
    ax = axes.numpy().tolist() if isinstance(axes, Tensor) else axes
    return apply_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax),
                    x, y)


def _atleast(op_name, fn):
    def op(*inputs, name=None):  # noqa: A002
        outs = [apply_op(op_name, fn, x) for x in inputs]
        return outs[0] if len(outs) == 1 else outs
    op.__name__ = op_name
    return op


atleast_1d = _atleast("atleast_1d", torch.atleast_1d)
atleast_2d = _atleast("atleast_2d", torch.atleast_2d)
atleast_3d = _atleast("atleast_3d", torch.atleast_3d)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    tdt = dtype_mod.to_torch_dtype(shape_or_dtype)
    return apply_op("view_dtype", lambda a: a.view(tdt), x)


def numel(x, name=None):
    return _on(x, np.asarray(x.size, dtype=np.int64))


def shape(x):
    return _on(x, np.asarray(x.shape, dtype=np.int32))


def rank(x):
    return _on(x, np.asarray(x.ndim, dtype=np.int32))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_op("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), x)


def reverse(x, axis, name=None):
    """Alias of :func:`flip`."""
    return flip(x, axis)


def unstack(x, axis=0, num=None, name=None):
    """Unit slices along ``axis`` (:func:`unbind`)."""
    return unbind(x, axis)


def vsplit(x, num_or_sections, name=None):
    if len(x.shape) < 2:
        raise ValueError("vsplit expects a tensor of rank >= 2")
    return split(x, num_or_sections, axis=0)


def tolist(x):
    return x.numpy().tolist()
