"""Process groups: the port of ``paddle_tpu/distributed/group.py``.

A ``Group`` keeps the reference's surface (``ranks``, ``id``, ``nranks``,
``rank`` numbered within the group, ``get_group_rank``, ``is_member``,
``process_ids``, the optional ``mesh_axis`` it stands for) over a
``torch.distributed`` process group (``pg``) when the world is initialized
(``env.init_parallel_env``), plus a gloo group (``meta_pg``) for the small
host-side exchanges: the collectives' cross-rank consistency check and the
object collectives. As in torch, ``new_group`` is itself collective: every
rank of the world calls it, for every group, in the same order.

``Task`` is the handle ``sync_op=False`` returns: ``wait()`` blocks until
the collective (and any copy back from its host staging) is done.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from . import env

__all__ = ["Task", "Group", "new_group", "get_group",
           "destroy_process_group"]


class Task:
    """A collective's handle (the reference's ``ProcessGroup::Task``):
    ``work`` a torch ``Work`` (None: already done), ``after`` run once the
    work completed (a staged result copied back)."""

    def __init__(self, work=None, after: Optional[Callable[[], None]] = None):
        self._work = work
        self._after = after

    def is_completed(self):
        return self._work is None or self._work.is_completed()

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._after is not None:
            after, self._after = self._after, None
            after()
        return True

    def synchronize(self):
        self.wait()


class Group:
    def __init__(self, ranks: List[int], gid: int = 0,
                 mesh_axis: Optional[str] = None, pg=None, meta_pg=None):
        self.ranks = list(ranks)
        self.id = gid
        self.mesh_axis = mesh_axis
        self.pg = pg
        self.meta_pg = meta_pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    @property
    def process_ids(self):
        return self.ranks

    @property
    def rank(self):
        return self.get_group_rank(env.global_rank())

    def get_group_rank(self, rank):
        try:
            return self.ranks.index(rank)
        except ValueError:
            return -1

    def is_member(self):
        return env.global_rank() in self.ranks

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.mesh_axis})")


_groups = {}
_next_gid = [1]
_default_group: Optional[Group] = None


def _torch_groups(ranks, backend=None):
    """(pg, meta_pg) for ``ranks``; (None, None) before the world is
    initialized. Every rank of the world must make the same calls."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    world = dist.get_world_size()
    if sorted(ranks) == list(range(world)) and backend is None:
        pg = dist.group.WORLD
    else:
        pg = dist.new_group(ranks, backend=backend)
    if env.backend() == "gloo" and backend in (None, "gloo"):
        meta = pg
    else:
        meta = dist.new_group(ranks, backend="gloo")
    return pg, meta


def _get_or_create_default() -> Group:
    global _default_group
    if _default_group is None or (_default_group.pg is None
                                  and env.is_initialized()):
        ranks = list(range(env.get_world_size()))
        pg, meta = _torch_groups(ranks)
        _default_group = Group(ranks, gid=0, pg=pg, meta_pg=meta)
    return _default_group


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _get_or_create_default()
    return _groups[gid]


def new_group(ranks=None, backend=None, timeout=None,
              mesh_axis: Optional[str] = None) -> Group:
    """``paddle.distributed.new_group``: a group of ``ranks`` (default: the
    world), numbered in sorted order. Collective over the world."""
    if ranks is None:
        ranks = list(range(env.get_world_size()))
    ranks = sorted(int(r) for r in ranks)
    gid = _next_gid[0]
    _next_gid[0] += 1
    pg, meta = _torch_groups(ranks, backend)
    g = Group(ranks, gid, mesh_axis=mesh_axis, pg=pg, meta_pg=meta)
    _groups[gid] = g
    return g


def destroy_process_group(group=None):
    """Destroy one group, or (``None``) every group and the world's process
    group and store, after which ``init_parallel_env`` may run again."""
    global _default_group
    import torch.distributed as dist
    if group is None:
        _groups.clear()
        _default_group = None
        env._shutdown()
        return
    _groups.pop(group.id, None)
    if group.pg is not None and dist.is_initialized() and \
            group.pg is not dist.group.WORLD:
        dist.destroy_process_group(group.pg)
