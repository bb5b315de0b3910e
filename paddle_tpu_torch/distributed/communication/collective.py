"""Eager collectives (``paddle.distributed.*``): the port of
``paddle_tpu/distributed/communication/collective.py`` (``:282-628``).

Three regimes, as the reference's:

- a group of one rank: the identity (the reference's behaviour);
- several ranks: the operation runs over the group's ``torch.distributed``
  process group (``group.py``), built by ``env.init_parallel_env`` on the
  backend the rule picks (NCCL, or gloo when ranks share a card);
- under a one-process mesh there are no ranks: the mesh code calls its
  collectives itself (``mesh_utils.reduce_in_slot_order``).

The semantics are the reference's, name for name: ``all_reduce``,
``broadcast`` and ``reduce_scatter`` write their tensor in place, the list
collectives extend the caller's list in group-rank order, ``reduce``
leaves the result on every rank (the reference's is an all-reduce, whose
``dst`` is kept logically), ``src``/``dst``/``peer`` are global ranks, and
``ReduceOp`` maps SUM, MAX, MIN, PROD and AVG (AVG is a SUM divided by the
group's size; integers truncate, as the reference's numpy mean cast back).
``sync_op=False`` returns a :class:`~..group.Task` whose ``wait()`` blocks
until the operation (and any copy back) is done.

Before ``all_reduce``, ``all_gather``, ``reduce``, ``reduce_scatter`` and
``all_to_all``, the ranks exchange their tensors' shapes and dtypes over
the group's gloo side group and a disagreement raises
:class:`CollectiveMismatchError` on every rank, naming each rank's tensor:
the reference's cross-rank check (``_check_consistent``).

**Gloo and CUDA tensors.** Where gloo carries the collective and the
tensor is on the card, the operations named in ``GLOO_CUDA_OPS`` hand
gloo the CUDA tensor itself: ``all_reduce``, ``broadcast`` (and
``reduce``, an all-reduce), ``all_gather``, ``reduce_scatter``,
``all_to_all`` and ``all_to_all_single``, ``scatter`` and ``gather``, each
of which took CUDA tensors in a probe on an H100 (torch 2.11, two gloo
ranks on one card). Gloo's point-to-point transport writes the buffer as
host memory and fails on a device pointer there ("writev: Bad address"),
so the point-to-point operations are staged through host memory in the
open: ``send``, ``recv``, ``isend``, ``irecv`` and ``batch_isend_irecv``
copy a CUDA tensor to the CPU, run there, and copy a received result back
into the caller's tensor. Under NCCL nothing is staged.
"""
from __future__ import annotations

import types
from typing import List

import torch

from .. import env
from ..group import Group, Task, get_group

__all__ = ["ReduceOp", "CollectiveMismatchError", "GLOO_CUDA_OPS",
           "all_reduce", "all_gather", "all_gather_object", "broadcast",
           "broadcast_object_list", "reduce", "reduce_scatter",
           "all_to_all", "all_to_all_single", "scatter",
           "scatter_object_list", "gather", "send", "recv", "isend",
           "irecv", "barrier", "P2POp", "batch_isend_irecv", "stream"]

# gloo operations that take CUDA tensors as they are (the point-to-point
# ones are staged through host memory)
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                           "reduce_scatter", "all_to_all",
                           "all_to_all_single", "scatter", "gather"})


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class CollectiveMismatchError(RuntimeError):
    """Ranks of one group called a collective with tensors of different
    shapes or dtypes."""


def _torch_op(op):
    import torch.distributed as dist
    table = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
             ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}
    if op not in table:
        raise ValueError(f"unknown reduce op {op}")
    return table[op]


def _np_reduce(stacked, op):
    """The reference's numpy reduction over stacked rank values (the CPU
    tests hold the collectives against it)."""
    if op in (ReduceOp.SUM, "sum"):
        return stacked.sum(0)
    if op in (ReduceOp.MAX, "max"):
        return stacked.max(0)
    if op in (ReduceOp.MIN, "min"):
        return stacked.min(0)
    if op in (ReduceOp.AVG, "avg"):
        return stacked.mean(0)
    if op in (ReduceOp.PROD, "prod"):
        return stacked.prod(0)
    raise ValueError(f"unknown reduce op {op}")


# ------------------------------------------------------------- helpers
def _t(x) -> torch.Tensor:
    """The torch tensor behind a Paddle ``Tensor`` (or the tensor)."""
    data = getattr(x, "_data", None)
    return data if isinstance(data, torch.Tensor) else x


def _like(template, t: torch.Tensor):
    """``t`` wrapped as the caller's tensors are: a Paddle ``Tensor`` for
    Paddle inputs, else the torch tensor."""
    if isinstance(template, torch.Tensor):
        return t
    from ...core.tensor import Tensor
    return Tensor._wrap(t)


def _group(group) -> Group:
    return group if group is not None else get_group(0)


def _n(group) -> int:
    return group.nranks if group is not None else env.get_world_size()


def _member(g: Group) -> int:
    me = env.global_rank()
    if me not in g.ranks:
        raise RuntimeError(
            f"rank {me} called a collective on a group it is not a member "
            f"of (group ranks: {g.ranks})")
    if g.pg is None:
        raise RuntimeError(
            "eager multi-rank collectives need paddle.distributed."
            "init_parallel_env() first")
    return g.ranks.index(me)


def _root(g: Group, root) -> int:
    idx = g.get_group_rank(root)
    if idx is None or idx < 0 or idx >= g.nranks:
        raise ValueError(f"root rank {root} is not a member of the group")
    return idx


def _staged(op: str, t: torch.Tensor) -> bool:
    """True when ``op`` over ``t`` goes through host memory (gloo, a CUDA
    tensor, an operation gloo does not run on the card)."""
    return (t.is_cuda and env.backend() == "gloo"
            and op not in GLOO_CUDA_OPS)


def _on(op: str, t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend gets for ``op``: ``t`` itself, its host copy
    (staged), or a contiguous copy; a caller whose result lands in the
    returned tensor copies it back when it is not ``t``."""
    if _staged(op, t):
        return t.cpu().contiguous()
    return t if t.is_contiguous() else t.contiguous()


def _check_consistent(op: str, t: torch.Tensor, g: Group):
    """The reference's cross-rank check: every member's shape and dtype,
    exchanged over the gloo side group; a disagreement raises on every
    rank, naming each rank's tensor."""
    import torch.distributed as dist
    mine = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    got: List = [None] * g.nranks
    dist.all_gather_object(got, mine, group=g.meta_pg)
    if len(set(got)) > 1:
        detail = ", ".join(f"rank {r}: shape={s} dtype={d}"
                           for r, (s, d) in zip(g.ranks, got))
        raise CollectiveMismatchError(
            f"collective '{op}' called with mismatched tensors across "
            f"ranks ({detail}); every member of the group must pass the "
            f"same shape/dtype")


def _finish(work, sync_op: bool, after=None) -> Task:
    task = Task(work, after)
    if sync_op:
        task.wait()
    return task


# --------------------------------------------------------- collectives
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place on every rank."""
    if _n(group) <= 1:
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    t = _t(tensor)
    _check_consistent("all_reduce", t, g)
    buf = _on("all_reduce", t)
    work = dist.all_reduce(buf, op=_torch_op(op), group=g.pg, async_op=True)

    def after():
        if op in (ReduceOp.AVG, "avg"):
            if buf.is_floating_point() or buf.is_complex():
                buf.div_(g.nranks)
            else:
                buf.copy_(torch.div(buf, g.nranks, rounding_mode="trunc"))
        if buf is not t:
            t.copy_(buf)
    return _finish(work, sync_op, after)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Extend ``tensor_list`` with every member's ``tensor``, in group-rank
    order."""
    if _n(group) <= 1:
        tensor_list.append(tensor)
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    t = _t(tensor)
    _check_consistent("all_gather", t, g)
    src = _on("all_gather", t)
    outs = [torch.empty_like(src) for _ in range(g.nranks)]
    work = dist.all_gather(outs, src.contiguous(), group=g.pg, async_op=True)

    def after():
        tensor_list.extend(_like(tensor, o.to(t.device)) for o in outs)
    return _finish(work, sync_op, after)


def all_gather_object(object_list, obj, group=None):
    """Extend ``object_list`` with every member's picklable ``obj``."""
    if _n(group) <= 1:
        object_list.append(obj)
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    got: List = [None] * g.nranks
    dist.all_gather_object(got, obj, group=g.meta_pg)
    object_list.extend(got)
    return Task()


def broadcast(tensor, src, group=None, sync_op=True):
    """``src``'s (a global rank) ``tensor`` written into every member's."""
    if _n(group) <= 1:
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    _root(g, src)
    t = _t(tensor)
    buf = _on("broadcast", t)
    work = dist.broadcast(buf, src=src, group=g.pg, async_op=True)
    return _finish(work, sync_op,
                   (lambda: t.copy_(buf)) if buf is not t else None)


def broadcast_object_list(object_list, src=0, group=None):
    if _n(group) <= 1:
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    _root(g, src)
    box = [list(object_list)]
    dist.broadcast_object_list(box, src=src, group=g.meta_pg)
    object_list[:] = box[0]
    return Task()


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reference's reduce: an all-reduce (every rank holds the result;
    ``dst`` is kept logically and checked)."""
    if _n(group) > 1:
        _root(_group(group), dst)
    return all_reduce(tensor, op, group, sync_op)


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """The group's reduction of the input (a list is concatenated along
    dim 0), split in even rows: this member's block into ``tensor``."""
    inp = tensor_list_or_input
    if isinstance(inp, (list, tuple)):
        inp = torch.cat([_t(x) for x in inp], dim=0)
    inp = _t(inp)
    t = _t(tensor)
    if _n(group) <= 1:
        t.copy_(inp.reshape(t.shape))
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    _check_consistent("reduce_scatter", inp, g)
    src = _on("reduce_scatter", inp).contiguous()
    out = _on("reduce_scatter", t)
    if out is t:
        out = torch.empty_like(t)
    work = dist.reduce_scatter_tensor(out, src, op=_torch_op(op),
                                      group=g.pg, async_op=True)

    def after():
        if op in (ReduceOp.AVG, "avg"):
            if out.is_floating_point():
                out.div_(g.nranks)
            else:
                out.copy_(torch.div(out, g.nranks, rounding_mode="trunc"))
        t.copy_(out)
    return _finish(work, sync_op, after)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Member j receives every member's ``in_tensor_list[j]``, in
    group-rank order, appended to its ``out_tensor_list``. The list is
    stacked and exchanged as one ``all_to_all_single`` (gloo has no list
    form)."""
    if _n(group) <= 1:
        out_tensor_list.extend(in_tensor_list)
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    ins = [_t(x) for x in in_tensor_list]
    stacked = torch.stack(ins)
    _check_consistent("all_to_all", stacked, g)
    src = _on("all_to_all", stacked)
    dst = torch.empty_like(src)
    work = dist.all_to_all_single(dst, src, group=g.pg, async_op=True)
    dev = ins[0].device

    def after():
        out_tensor_list.extend(_like(in_tensor_list[0], o.to(dev))
                               for o in dst.unbind(0))
    return _finish(work, sync_op, after)


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    """``in_tensor``'s dim-0 blocks scattered to the members and theirs
    gathered into ``out_tensor`` (even blocks, or the given sizes)."""
    o, i = _t(out_tensor), _t(in_tensor)
    if _n(group) <= 1:
        o.copy_(i)
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    if not (out_split_sizes or in_split_sizes) and \
            i.shape[0] % g.nranks != 0:
        raise ValueError(
            f"all_to_all_single dim 0 ({i.shape[0]}) must divide the "
            f"group size ({g.nranks})")
    src = _on("all_to_all_single", i).contiguous()
    dst = _on("all_to_all_single", o)
    if dst is o:
        dst = torch.empty_like(o)
    work = dist.all_to_all_single(dst, src, out_split_sizes, in_split_sizes,
                                  group=g.pg, async_op=True)
    return _finish(work, sync_op, lambda: o.copy_(dst))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``src``'s ``tensor_list[j]`` into member j's ``tensor``."""
    t = _t(tensor)
    if _n(group) <= 1:
        if tensor_list:
            t.copy_(_t(tensor_list[0]))
        return Task()
    import torch.distributed as dist
    g = _group(group)
    idx = _member(g)
    root = _root(g, src)
    out = _on("scatter", t)
    if out is t:
        out = torch.empty_like(t)
    lst = None
    if idx == root:
        lst = [_on("scatter", _t(x)).contiguous() for x in tensor_list]
    work = dist.scatter(out, lst, src=src, group=g.pg, async_op=True)
    return _finish(work, sync_op, lambda: t.copy_(out))


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    if _n(group) <= 1:
        out_object_list.extend(in_object_list or [])
        return Task()
    import torch.distributed as dist
    g = _group(group)
    idx = _member(g)
    root = _root(g, src)
    box = [None]
    dist.scatter_object_list(box, list(in_object_list)
                             if idx == root else None,
                             src=src, group=g.meta_pg)
    out_object_list.append(box[0])
    return Task()


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every member's ``tensor`` appended, in group-rank order, to ``dst``'s
    ``gather_list``."""
    if _n(group) <= 1:
        if gather_list is not None:
            gather_list.append(tensor)
        return Task()
    import torch.distributed as dist
    g = _group(group)
    idx = _member(g)
    root = _root(g, dst)
    t = _t(tensor)
    src = _on("gather", t).contiguous()
    outs = [torch.empty_like(src) for _ in range(g.nranks)] \
        if idx == root else None
    work = dist.gather(src, outs, dst=dst, group=g.pg, async_op=True)

    def after():
        if outs is not None and gather_list is not None:
            gather_list.extend(_like(tensor, o.to(t.device)) for o in outs)
    return _finish(work, sync_op, after)


def _p2p_group(group) -> Group:
    g = _group(group)
    _member(g)
    return g


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst``; repeated sends pair
    with the peer's receives in order."""
    if env.get_world_size() <= 1:
        return Task()
    import torch.distributed as dist
    g = _p2p_group(group)
    buf = _on("send", _t(tensor)).contiguous()
    work = dist.isend(buf, dst=dst, group=g.pg)
    return _finish(work, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive from global rank ``src`` into ``tensor``."""
    if env.get_world_size() <= 1:
        return Task()
    import torch.distributed as dist
    g = _p2p_group(group)
    t = _t(tensor)
    buf = _on("recv", t)
    if buf is t and not t.is_contiguous():
        buf = t.contiguous()
    work = dist.irecv(buf, src=src, group=g.pg)
    return _finish(work, sync_op,
                   (lambda: t.copy_(buf)) if buf is not t else None)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def barrier(group=None):
    """Block until every member arrives."""
    if _n(group) <= 1:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return Task()
    import torch.distributed as dist
    g = _group(group)
    _member(g)
    dist.barrier(group=g.meta_pg)
    return Task()


class P2POp:
    """One operation of a ``batch_isend_irecv`` batch: ``op`` is
    ``isend`` or ``irecv`` (this module's or torch's), ``peer`` a global
    rank."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list) -> List[Task]:
    """Post a batch of sends and receives together (so a ring exchange
    cannot deadlock) and return their tasks; a received tensor holds its
    value once its task's ``wait()`` returns."""
    if env.get_world_size() <= 1:
        return [Task() for _ in p2p_op_list]
    import torch.distributed as dist
    ops, afters = [], []
    for p in p2p_op_list:
        g = _p2p_group(p.group)
        is_send = p.op in (isend, send, dist.isend, dist.send)
        t = _t(p.tensor)
        buf = _on("send" if is_send else "recv", t).contiguous()
        ops.append(dist.P2POp(dist.isend if is_send else dist.irecv, buf,
                              p.peer, group=g.pg))
        afters.append(None if (is_send or buf is t) else
                      (lambda t=t, buf=buf: t.copy_(buf)))
    works = dist.batch_isend_irecv(ops)
    return [Task(w, a) for w, a in zip(works, afters)]


def _stream_variant(fn):
    def wrapper(*args, **kwargs):
        kwargs.pop("use_calc_stream", None)
        return fn(*args, **kwargs)
    wrapper.__name__ = fn.__name__
    return wrapper


# ``paddle.distributed.stream.*`` (reference communication/stream/): the
# same operations; ``use_calc_stream`` is accepted and has no effect
stream = types.SimpleNamespace(
    all_reduce=_stream_variant(all_reduce),
    all_gather=_stream_variant(all_gather),
    all_to_all=_stream_variant(all_to_all),
    all_to_all_single=_stream_variant(all_to_all_single),
    broadcast=_stream_variant(broadcast),
    reduce=_stream_variant(reduce),
    reduce_scatter=_stream_variant(reduce_scatter),
    scatter=_stream_variant(scatter),
    send=_stream_variant(send),
    recv=_stream_variant(recv),
)
