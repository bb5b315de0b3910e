"""The device mesh of one process: the port of
``paddle_tpu/distributed/mesh_utils.py``.

In the reference one process drives every local device through GSPMD and
``shard_map``: a ``jax.sharding.Mesh`` names the axes ("dp", "pp",
"sharding", "sep", "mp"), and an array placed with a ``NamedSharding``
lives as one shard per device. The port keeps that regime without GSPMD:

- :class:`Mesh` holds axis names, degrees and a grid of **device slots**.
  A slot is a ``torch.device``, and slots may repeat a device: on one card
  ``build_mesh({"mp": 2}, devices=["cuda:0", "cuda:0"])`` is a live mesh of
  two slots, in the CPU tests eight ``cpu`` slots stand in for the
  reference's eight virtual CPU devices. On a host with N cards slot i is
  ``cuda:i``.
- :class:`MeshTensor` is a tensor placed on a mesh: its spec, its mesh and
  one contiguous tensor per slot (each its own allocation, on the slot's
  device). ``full()`` gathers it back. torch's ``DeviceMesh``/``DTensor``
  are not used: both need one process per rank, which one card cannot have
  under NCCL.
- The collectives GSPMD inserts are explicit calls of the code that runs
  on a mesh (``models/gpt.py``'s per-slot decoder layer): partial sums are
  reduced in slot order, so a result never depends on timing.

``build_mesh`` keeps the reference's contract: without ``devices=`` it takes
the visible devices (the CUDA devices; the CPU when there is none) and
raises when there are too few, so on one card a live mesh is asked for
explicitly. The global mesh is thread-local, as the reference's.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "MeshTensor", "NamedSharding", "build_mesh",
           "visible_devices", "set_global_mesh", "get_global_mesh",
           "mesh_axis_size", "named_sharding", "shard_tensor_data",
           "with_constraint", "batch_axis_constraint", "manual_shard_map",
           "reduce_in_slot_order"]

_state = threading.local()


class Mesh:
    """Axis names, degrees and a grid of device slots (``devices``, a numpy
    object array of ``torch.device`` shaped by the degrees). ``shape`` is
    the ordered ``{axis: degree}`` map, ``size`` the number of slots,
    ``slots`` the slots in row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of {len(axis_names)} axes needs a "
                             f"{len(axis_names)}-d device grid, got "
                             f"{grid.ndim}-d")
        flat = [torch.device(d) for d in grid.flat]
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(str(a) for a in axis_names)
        self.shape = dict(zip(self.axis_names,
                              (int(n) for n in grid.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> List[torch.device]:
        return list(self.devices.flat)

    def coords(self, slot: int) -> Dict[str, int]:
        """The slot's coordinate on each axis."""
        idx = np.unravel_index(slot, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.shape == other.shape and \
            [str(d) for d in self.slots] == [str(d) for d in other.slots]

    def __hash__(self):
        return hash((tuple(self.shape.items()),
                     tuple(str(d) for d in self.slots)))

    def __repr__(self):
        return (f"Mesh({self.shape}, slots="
                f"{[str(d) for d in self.slots]})")


class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _block(mesh: Mesh, spec: tuple, shape: Sequence[int], slot: int):
    """The index tuple of the slot's block of a ``shape`` array under a
    normalized ``spec``: each sharded dim split in even pieces, numbered
    row-major over its axes' coordinates."""
    coords = mesh.coords(slot)
    out = []
    for dim, size in enumerate(shape):
        axes = _axes_of(spec[dim]) if dim < len(spec) else ()
        pieces, index = 1, 0
        for a in axes:
            pieces *= mesh.shape[a]
            index = index * mesh.shape[a] + coords[a]
        step = size // pieces
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


class MeshTensor:
    """A tensor placed on a mesh: ``spec`` (normalized against ``mesh`` and
    the shape), ``mesh``, and ``shards``, one contiguous tensor per slot in
    slot order. ``shape`` and ``dtype`` are the logical (full) tensor's.
    Build one with :meth:`place`; :meth:`full` gathers it."""

    def __init__(self, shards: List[torch.Tensor], spec: tuple, mesh: Mesh,
                 shape: Sequence[int]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} slots")
        self.shards = list(shards)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.dtype = shards[0].dtype

    @classmethod
    def place(cls, tensor: torch.Tensor, mesh: Mesh, spec=()) -> "MeshTensor":
        """Split ``tensor`` by ``spec`` (degraded against the mesh and the
        shape, as ``shard.normalize_spec``) into one contiguous copy per
        slot on that slot's device."""
        from .shard import normalize_spec
        if isinstance(tensor, MeshTensor):
            tensor = tensor.full()
        spec = normalize_spec(spec, mesh, tuple(tensor.shape))
        shards = []
        for s, dev in enumerate(mesh.slots):
            block = tensor[_block(mesh, spec, tensor.shape, s)]
            shards.append(block.to(dev, copy=True,
                                   memory_format=torch.contiguous_format))
        return cls(shards, spec, mesh, tensor.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """Slot 0's device."""
        return self.shards[0].device

    def shard(self, slot: int) -> torch.Tensor:
        return self.shards[slot]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor],
            shape: Optional[Sequence[int]] = None) -> "MeshTensor":
        """``fn`` applied to every shard; ``shape`` the new logical shape
        (default: unchanged)."""
        return MeshTensor([fn(t) for t in self.shards], self.spec,
                          self.mesh, self.shape if shape is None else shape)

    def full(self, device=None) -> torch.Tensor:
        """The logical tensor, gathered onto ``device`` (default: slot 0's
        device). A replicated block is read from its first slot."""
        device = torch.device(device) if device is not None else self.device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for s, t in enumerate(self.shards):
            idx = _block(self.mesh, self.spec, self.shape, s)
            key = tuple((i.start, i.stop) for i in idx)
            if key in seen:
                continue
            seen.add(key)
            out[idx] = t.to(device)
        return out

    def numel(self) -> int:
        """The logical tensor's element count."""
        return int(np.prod(self.shape)) if len(self.shape) else 1

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def nbytes_per_slot(self) -> List[int]:
        return [t.numel() * t.element_size() for t in self.shards]

    def __repr__(self):
        return (f"MeshTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def visible_devices() -> List[torch.device]:
    """The devices a mesh takes by default: every CUDA device, or the CPU
    when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """``axes``: ordered ``{axis_name: degree}``; the degrees' product
    slots, taken from ``devices`` (default: :func:`visible_devices`), which
    must hold at least that many. Axes of degree 1 are kept, so specs stay
    stable (reference ``mesh_utils.py:23-34``)."""
    devices = list(devices) if devices is not None else visible_devices()
    names = list(axes.keys())
    degrees = [int(axes[n]) for n in names]
    total = int(np.prod(degrees)) if degrees else 1
    if total > len(devices):
        raise ValueError(
            f"mesh {axes} needs {total} devices, only {len(devices)} visible")
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(degrees), names)


def set_global_mesh(mesh: Optional[Mesh]):
    _state.mesh = mesh


def get_global_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def mesh_axis_size(axis: str) -> int:
    mesh = get_global_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def named_sharding(*spec) -> Optional[NamedSharding]:
    mesh = get_global_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec)


def shard_tensor_data(arr, *spec):
    """Place a tensor with ``spec`` on the global mesh (a
    :class:`MeshTensor`); the tensor itself without one."""
    mesh = get_global_mesh()
    if mesh is None:
        return arr
    return MeshTensor.place(arr, mesh, spec)


def _live(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def with_constraint(arr, *spec):
    """Pin ``arr`` to ``spec`` on the global mesh: the identity without a
    live global mesh; otherwise the tensor re-placed by the spec (axes the
    mesh lacks, or has at size 1, degrade to replication)."""
    mesh = get_global_mesh()
    if not _live(mesh):
        return arr
    return MeshTensor.place(arr, mesh, spec)


def batch_axis_constraint(h):
    """Pin activations to batch-axis sharding (``shard.constrain_batch``);
    the identity without a live global mesh."""
    from .shard import constrain_batch
    return constrain_batch(h)


def manual_shard_map(f, mesh: Mesh, in_specs, out_specs):
    """``shard_map`` in manual mode: the returned function places each
    argument by its spec (a :class:`MeshTensor` keeps its placement), runs
    ``f`` once per slot on that slot's shards, and returns a
    :class:`MeshTensor` of the per-slot results under ``out_specs`` (a
    tuple of them when ``f`` returns a tuple). ``f`` does its own
    collectives, as the reference's bodies do."""
    def run(*args):
        placed = []
        for a, spec in zip(args, in_specs):
            if isinstance(a, MeshTensor):
                placed.append(a)
            elif isinstance(a, torch.Tensor):
                placed.append(MeshTensor.place(a, mesh, spec))
            else:
                placed.append(a)
        outs = []
        for s in range(mesh.size):
            outs.append(f(*(a.shard(s) if isinstance(a, MeshTensor) else a
                            for a in placed)))
        multi = isinstance(outs[0], tuple)
        cols = list(zip(*outs)) if multi else [outs]
        specs = out_specs if multi else (out_specs,)
        result = []
        for col, spec in zip(cols, specs):
            shape = list(col[0].shape)
            for d, e in enumerate(tuple(spec)):
                for a in _axes_of(e):
                    shape[d] *= mesh.shape[a]
            result.append(MeshTensor(list(col), tuple(spec), mesh, shape))
        return tuple(result) if multi else result[0]
    return run


def reduce_in_slot_order(parts: List[torch.Tensor], dtype=None,
                         device=None) -> torch.Tensor:
    """Sum per-slot partial results in slot order, in float32, on
    ``device`` (default: the first part's), rounded once to ``dtype``
    (default: the parts' own): the explicit reduction of a row-parallel
    product, the same on every call."""
    device = parts[0].device if device is None else torch.device(device)
    acc = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device, torch.float32)
    return acc.to(dtype or parts[0].dtype)
