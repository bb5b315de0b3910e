"""Tensor-parallel serving mesh: one replica spans the slots of a
``{"mp": N}`` mesh. The port of ``paddle_tpu/serving/mesh.py``.

``ServingMesh`` is the serving-side handle the decode engine, the servers
and the fleet worker attach; from then on

- **weights** shard by the ``distributed.shard`` rule tables (``spec_tree``,
  Paddle layout, reversed for the torch layout of linear weights), placed
  once as ``MeshTensor``s: each slot holds its own contiguous shard;
- **paged KV pools** shard along the heads axis: each slot holds its own
  contiguous ``[num_pages, page_size, heads/mp, head_dim]`` tensor of every
  pool (an int8 pool's scale planes ``[..., heads/mp]`` shard with their
  values). The prefix cache's radix index, refcounts and block tables are
  host-side and layout-agnostic: they ride unchanged;
- the decoder (``models/gpt.py::mesh_forward``) runs each layer per slot and
  reduces the partial sums in slot order; logits are replicated on the way
  out;
- the mesh's axes, slots and the weight spec-tree hash join every decode
  fingerprint and compile-cache key, so a mesh change is a compile-cache
  miss, while an inert mesh (None, or one slot) leaves every fingerprint,
  key and placement byte for byte as without one.

The mesh is threaded explicitly (constructor arguments), not through the
thread-local global mesh: the engine dispatches from a worker thread.
A ``ServingMesh`` is immutable after construction.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["ServingMesh", "serving_mesh_from_flags"]


class ServingMesh:
    """Immutable wrapper over a serving replica's mesh (``None``, a
    ``distributed.mesh_utils.Mesh`` or another ``ServingMesh``). A mesh of
    one slot is inert: every helper is the identity and ``live`` is
    False."""

    def __init__(self, mesh=None):
        if isinstance(mesh, ServingMesh):
            mesh = mesh.mesh
        self.mesh = mesh

    # ------------------------------------------------------- identity
    @property
    def live(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def axes(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return {str(k): int(v) for k, v in dict(self.mesh.shape).items()}

    @property
    def mp(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get("mp", 1))

    @property
    def devices(self) -> int:
        """The number of slots."""
        return int(self.mesh.size) if self.mesh is not None else 1

    @property
    def slots(self):
        return self.mesh.slots if self.mesh is not None else []

    def mesh_for_cache_key(self):
        """The mesh folded into ``compile_cache.cache_key``: the mesh when
        live, None otherwise (the single-shard key)."""
        return self.mesh if self.live else None

    def validate_heads(self, num_heads: int) -> None:
        """Fail fast when the heads axis cannot shard evenly, or when the
        mesh has a live axis besides ``mp``."""
        if not self.live:
            return
        other = {a: n for a, n in self.axes.items() if a != "mp" and n > 1}
        if other:
            raise ValueError(
                f"a serving mesh shards over 'mp' only; axes {other} have "
                f"no serving path")
        if num_heads % self.mp != 0:
            raise ValueError(
                f"num_heads={num_heads} is not divisible by the "
                f"serving mesh's mp={self.mp}: the paged KV pools "
                f"shard along the heads axis (heads/mp per slot)")

    # ----------------------------------------------------- weight side
    def weight_specs(self, model) -> Dict[str, tuple]:
        """``{param-path: spec}`` (Paddle layout) through the rule
        tables, normalized against this mesh; empty when inert."""
        if not self.live:
            return {}
        from ..distributed.shard import spec_tree
        return spec_tree(model, mesh=self.mesh)

    def place_state(self, params: Optional[dict] = None,
                    buffers: Optional[dict] = None,
                    specs: Optional[Dict[str, tuple]] = None, model=None):
        """Place a ``(params, buffers)`` snapshot (default: ``model``'s):
        params by their spec tree (Paddle layout; inferred from ``model``
        when not given), buffers replicated. Returns two ``{path:
        MeshTensor}`` dicts; the inputs unchanged when inert."""
        if params is None:
            params = {n: p.detach() for n, p in model.named_parameters()}
        if buffers is None:
            buffers = ({n: b for n, b in model.named_buffers()}
                       if model is not None else {})
        if not self.live:
            return params, buffers
        from ..distributed.mesh_utils import MeshTensor
        from ..distributed.shard import linear_weight_paths, torch_spec
        if specs is None:
            specs = self.weight_specs(model)
        linear = linear_weight_paths(model) if model is not None else set()
        placed = {name: MeshTensor.place(
            a, self.mesh, torch_spec(specs.get(name) or (), name in linear))
            for name, a in params.items()}
        bufs = {name: MeshTensor.place(a, self.mesh, ())
                for name, a in buffers.items()}
        return placed, bufs

    # ------------------------------------------------------- pool side
    @staticmethod
    def _pool_leaf_spec(leaf, quantized: bool) -> tuple:
        """Heads-axis spec of one pool leaf: values end in ``[..., heads,
        head_dim]``; an int8 pool's float scale planes end in ``[...,
        heads]`` (told apart by dtype, as the reference's)."""
        import torch
        if leaf.dtype == torch.int8 or not quantized:
            return (None,) * (leaf.ndim - 2) + ("mp", None)
        return (None,) * (leaf.ndim - 1) + ("mp",)

    @staticmethod
    def _leaves(pools):
        if isinstance(pools, (list, tuple)):
            return [t for p in pools for t in ServingMesh._leaves(p)]
        return [pools]

    def pool_specs(self, pools):
        """The matching structure of normalized specs for a pool
        structure."""
        import torch

        from ..distributed.shard import normalize_spec
        quantized = any(t.dtype == torch.int8 for t in self._leaves(pools))

        def spec(p):
            if isinstance(p, list):
                return [spec(x) for x in p]
            if isinstance(p, tuple):
                return tuple(spec(x) for x in p)
            return normalize_spec(self._pool_leaf_spec(p, quantized),
                                  self.mesh, tuple(p.shape))
        return spec(pools)

    def place_pools(self, k, v):
        """Heads-sharded placement of the K/V pool structures: each leaf a
        ``MeshTensor`` whose slots own contiguous tensors. Identity when
        inert."""
        if not self.live:
            return k, v
        from ..distributed.mesh_utils import MeshTensor
        specs = self.pool_specs((k, v))

        def put(p, s):
            if isinstance(p, list):
                return [put(a, b) for a, b in zip(p, s)]
            if isinstance(p, tuple):
                return tuple(put(a, b) for a, b in zip(p, s))
            return p if isinstance(p, MeshTensor) else \
                MeshTensor.place(p, self.mesh, s)
        return put((k, v), specs)

    def constrain_pools(self, pools):
        """Pools pinned to their heads-axis placement: placed pools as
        they are, plain ones placed. Identity when inert."""
        if not self.live:
            return pools
        return self.place_pools(pools, [])[0]

    def replicate(self, x):
        """The full tensor of a placed one (on slot 0's device); anything
        else as it is."""
        from ..distributed.mesh_utils import MeshTensor
        return x.full() if isinstance(x, MeshTensor) else x

    # -------------------------------------------------- fingerprints
    def fingerprint_parts(self, model=None) -> Optional[dict]:
        """Fingerprint contribution: the mesh axes, its slots and the
        weight spec-tree hash; None when inert (callers omit the part, so
        inert meshes keep today's fingerprints byte for byte)."""
        if not self.live:
            return None
        from ..distributed.shard import spec_tree_hash
        parts = {"axes": self.axes,
                 "slots": [str(d) for d in self.mesh.slots]}
        if model is not None:
            parts["spec_hash"] = spec_tree_hash(self.weight_specs(model))
        return parts

    # ------------------------------------------------- observability
    def per_chip_pool_bytes(self, total_pool_bytes: int,
                            num_heads: int) -> int:
        """Per-slot KV-pool residency: the heads axis splits evenly."""
        if not self.live or num_heads % self.mp != 0:
            return int(total_pool_bytes)
        return int(total_pool_bytes) // self.mp

    def statusz(self, kv_pool_bytes: Optional[int] = None,
                num_heads: Optional[int] = None, pools=None) -> dict:
        """The ``/statusz`` section: liveness, axes, slots and, with the
        pools' bytes, each slot's share (``pools``: measured from the
        placed pools themselves)."""
        out = {"live": self.live, "axes": self.axes,
               "devices": self.devices,
               "slots": [str(d) for d in self.slots]}
        if kv_pool_bytes is not None and num_heads:
            out["per_chip_kv_pool_bytes"] = self.per_chip_pool_bytes(
                kv_pool_bytes, num_heads)
        if pools is not None and self.live:
            from ..distributed.mesh_utils import MeshTensor
            per = [0] * self.devices
            for t in self._leaves(pools):
                if isinstance(t, MeshTensor):
                    for s, n in enumerate(t.nbytes_per_slot()):
                        per[s] += n
            out["per_slot_kv_pool_bytes"] = per
        return out


def serving_mesh_from_flags(devices=None) -> ServingMesh:
    """The replica's serving mesh from ``FLAGS_serving_mesh_mp``: an
    ``{"mp": N}`` mesh over ``devices`` (default: the visible devices, so
    N slots need N of them; on one card pass ``devices`` explicitly), or
    an inert ``ServingMesh(None)`` at 1 or below."""
    from ..framework.flags import flag_value
    mp = int(flag_value("FLAGS_serving_mesh_mp") or 1)
    if mp <= 1:
        return ServingMesh(None)
    from ..distributed.mesh_utils import build_mesh
    return ServingMesh(build_mesh({"mp": mp}, devices=devices))
