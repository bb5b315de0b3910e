"""Hybrid-parallel topology: the port of
``paddle_tpu/distributed/fleet/topology.py``.

``CommunicateTopology`` and ``HybridCommunicateGroup`` keep the reference's
rank math (axis order "data", "pipe", "sharding", "sep", "model"). Each
axis group is a ``Group`` over a ``torch.distributed`` process group: torch
needs every rank to build every group, in the same order, so each rank
builds all of an axis's groups and keeps the one it belongs to. The mesh
of slots (``self.mesh``) is built over the visible devices when there are
enough of them, and set as the global mesh, as the reference's.
"""
from __future__ import annotations

import itertools
from functools import reduce

from .. import env
from ..group import Group, new_group
from ..mesh_utils import build_mesh, set_global_mesh

_AXIS_TO_MESH_NAME = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                      "sep": "sep", "expert": "ep", "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._world_size = reduce(lambda x, y: x * y, self._dims, 1)
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        key = tuple(args[name] for name in self._parallel_names)
        return self._coord2rank[key]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [rank for coord, rank in self._coord2rank.items()
                if coord[axis] == index]

    def get_comm_list(self, axis_name):
        """All rank-lists along axis_name (one per setting of other axes)."""
        axis = self._parallel_names.index(axis_name)
        other = [n for i, n in enumerate(self._parallel_names) if i != axis]
        ranges = [range(self.get_dim(n)) for n in other]
        out = []
        for combo in itertools.product(*ranges):
            grp = []
            for i in range(self._dims[axis]):
                coord = {}
                for n, v in zip(other, combo):
                    coord[n] = v
                coord[axis_name] = i
                grp.append(self.get_rank(**coord))
            out.append(grp)
        return out

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = env.global_rank()
        self._dp_degree = self._topo.get_dim("data")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self._mp_degree = self._topo.get_dim("model")
        self._sep_degree = (self._topo.get_dim("sep")
                            if "sep" in self._topo.get_hybrid_group_names()
                            else 1)

        # groups per axis (mesh-axis views)
        self._dp_group = self._make_group("data", "dp")
        self._pp_group = self._make_group("pipe", "pp")
        self._sharding_group = self._make_group("sharding", "sharding")
        self._mp_group = self._make_group("model", "mp")
        if "expert" in self._topo.get_hybrid_group_names():
            self._ep_group = self._make_group("expert", "ep")
        else:
            self._ep_group = None

        # the mesh of slots (only when enough devices are visible)
        try:
            axes = {}
            for name in self._topo.get_hybrid_group_names():
                axes[_AXIS_TO_MESH_NAME[name]] = self._topo.get_dim(name)
            self.mesh = build_mesh(axes)
            set_global_mesh(self.mesh)
        except ValueError:
            self.mesh = None

    def _make_group(self, axis_name, mesh_axis) -> Group:
        mine = None
        for ranks in self._topo.get_comm_list(axis_name):
            g = new_group(ranks, mesh_axis=mesh_axis)
            if self.global_rank in ranks:
                mine = g
        return mine if mine is not None else \
            Group([self.global_rank], mesh_axis=mesh_axis)

    # paddle topology API surface
    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1:
            return "data_parallel" if self._dp_degree > 1 else "single"
        return "hybrid_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_group.rank if self._dp_group.nranks > 1 else 0

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_group.rank if self._mp_group.nranks > 1 else 0

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._pp_group.rank if self._pp_group.nranks > 1 else 0

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_group.rank if self._sharding_group.nranks > 1 else 0

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    def get_sep_parallel_world_size(self):
        return self._sep_degree
