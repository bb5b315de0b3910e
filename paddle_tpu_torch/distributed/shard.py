"""The unified sharding API: the port of ``paddle_tpu/distributed/shard.py``.

One surface turns a model's parameters and a device mesh
(``mesh_utils.Mesh``) into a spec tree and places tensors by it, for the
serving mesh (``serving/mesh.py``), the checkpoint layer and, in part 2 of
ROADMAP queue 1 item 5c, training:

- **Spec inference** (``spec_tree``): the reference's rule table over
  parameter paths and shapes, with its precedence (overrides, then
  ``annotate``, then a parameter's own ``dist_spec``, then the rules, then
  replication).
- **Specs are in Paddle's layout.** Paths are the reference's (the port's
  models use its parameter names, ``convert.py``) and shapes are the
  reference's: an ``nn.Linear`` weight is ``[out, in]`` in torch and
  ``[in, out]`` in Paddle, and its spec is written, inferred, hashed and
  projected as the reference's ``[in, out]`` spec. So ``spec_tree``,
  ``spec_tree_hash`` and ``projected_bytes_per_chip`` give, for each model,
  the reference's answers. Placement (``shard_params``, ``shard_tree`` of a
  model state, ``ServingMesh.place_state``) reverses a linear weight's spec
  for the torch tensor (:func:`torch_spec`).
- **The TP layers' marks.** The reference's GPT, BERT and ERNIE build their
  projections from the tensor-parallel layers, which mark every parameter
  at construction (``mp_layers.py``); the port's models call
  ``fleet.meta_parallel.mark_megatron`` to write the same ``dist_spec``s.
- **ZeRO** (``zero=``): dim 0 shards over the ``sharding`` axis, computed
  here; training with it waits for part 2.
- **Placement** returns :class:`~.mesh_utils.MeshTensor` holders (a torch
  parameter cannot hold a sharded value), and the constraints are the
  identity without a live mesh.
- **Cache coherence** (``specs_generation``, ``spec_tree_hash``) and the
  ``paddle_shard_*`` gauges, as the reference's.

Thread-safety: the generation counter and metric publication are guarded
by ``_lock``; spec inference itself is pure.
"""
from __future__ import annotations

import fnmatch
import hashlib
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "REPLICATED", "ShardingRules", "default_rules",
    "normalize_spec", "spec_tree", "model_spec_tree", "spec_tree_hash",
    "annotate", "mark_param", "apply_sharding",
    "shard_tree", "shard_params", "sharding_tree", "param_shardings",
    "constrain", "constrain_batch", "constrain_seq",
    "batch_axes", "batch_spec",
    "specs_generation", "projected_bytes_per_chip", "publish_metrics",
    "ZERO_LEVELS",
]

REPLICATED: Tuple = ()

ZERO_LEVELS = ("os", "os_g", "p_g_os")

_lock = threading.Lock()
_generation = 0
_metrics = None


def specs_generation() -> int:
    """Process-wide sharding-annotation generation, bumped by every
    ``annotate``/``mark_param``/``apply_sharding``."""
    with _lock:
        return _generation


def _bump_generation():
    global _generation
    with _lock:
        _generation += 1


def _global(mesh):
    if isinstance(mesh, str) and mesh == "__global__":
        from .mesh_utils import get_global_mesh
        return get_global_mesh()
    return mesh


# --------------------------------------------------------------- specs
def _canon_spec(spec) -> Tuple:
    """Canonical tuple form: entries are None, an axis name, or a tuple of
    axis names."""
    if spec is None:
        return REPLICATED
    out = []
    for s in tuple(spec):
        if s is None or isinstance(s, str):
            out.append(s)
        elif isinstance(s, (tuple, list)):
            out.append(tuple(str(a) for a in s))
        else:
            raise TypeError(f"spec entry must be None, an axis name or "
                            f"a tuple of axis names, got {s!r}")
    return tuple(out)


def normalize_spec(spec, mesh, shape: Optional[Sequence[int]] = None
                   ) -> Tuple:
    """Degrade a spec against a mesh: axes the mesh lacks (or has at size
    1) become replication, and with ``shape`` a dim the surviving axes do
    not divide evenly is replicated. Without a mesh: ``REPLICATED``."""
    spec = _canon_spec(spec)
    if mesh is None:
        return REPLICATED

    def _axis_size(a):
        return mesh.shape[a] if a in mesh.axis_names else 1

    out = []
    for i, s in enumerate(spec):
        if isinstance(s, tuple):
            kept = tuple(a for a in s if _axis_size(a) > 1)
            size = 1
            for a in kept:
                size *= _axis_size(a)
            s = (kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            size = _axis_size(s) if s is not None else 1
            s = s if size > 1 else None
        if s is not None and shape is not None:
            if i >= len(shape) or shape[i] % size != 0:
                s = None
        out.append(s)
    return tuple(out)


def _spec_shards(spec, mesh_axes: Dict[str, int]) -> int:
    n = 1
    for s in _canon_spec(spec):
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                n *= int(mesh_axes.get(a, 1))
    return n


# --------------------------------------------------------------- rules
class ShardingRules:
    """Ordered (glob-pattern, spec) name rules over the parameter path,
    then shape heuristics, then replication. A spec may be a callable
    ``shape -> spec``."""

    def __init__(self, name_rules: Sequence[Tuple[str, Any]] = (),
                 use_shape_heuristics: bool = True):
        self.name_rules = list(name_rules)
        self.use_shape_heuristics = use_shape_heuristics

    def with_rules(self, *rules: Tuple[str, Any]) -> "ShardingRules":
        """A copy with extra name rules PREPENDED (first match wins)."""
        return ShardingRules(list(rules) + self.name_rules,
                             self.use_shape_heuristics)

    def spec_for(self, path: str, shape: Sequence[int]) -> Tuple:
        for pattern, spec in self.name_rules:
            if fnmatch.fnmatchcase(path, pattern):
                if callable(spec):
                    spec = spec(tuple(shape))
                return _canon_spec(spec)
        if self.use_shape_heuristics:
            return _canon_spec(self._shape_spec(tuple(shape)))
        return REPLICATED

    @staticmethod
    def _shape_spec(shape: Tuple[int, ...]):
        """The reference's shape heuristics (Paddle layout): an embedding
        table [V, H] with V >= 8H over 'mp' on dim 0; an up-projection
        [H, kH] on dim 1; a down-projection [kH, H] on dim 0; anything else
        replicated."""
        if len(shape) != 2 or 0 in shape:
            return None
        d0, d1 = shape
        if d1 < 8:
            return None
        if d0 >= 8 * d1:
            return ("mp", None)
        if d1 > d0 and d1 % d0 == 0 and d1 // d0 in (2, 3, 4, 8):
            return (None, "mp")
        if d0 > d1 and d0 % d1 == 0 and d0 // d1 in (2, 3, 4, 8):
            return ("mp", None)
        return None


_DEFAULT_NAME_RULES: List[Tuple[str, Any]] = [
    ("*word_embeddings.weight", ("mp", None)),
    ("*position_embeddings", REPLICATED),
    ("*token_type_embeddings", REPLICATED),
    ("*task_type_embeddings", REPLICATED),
    ("*qkv_proj.weight", (None, "mp")),
    ("*qkv_proj.bias", ("mp",)),
    ("*fc_in.weight", (None, "mp")),
    ("*fc_in.bias", ("mp",)),
    ("*out_proj.weight", ("mp", None)),
    ("*out_proj.bias", REPLICATED),
    ("*fc_out.weight", ("mp", None)),
    ("*fc_out.bias", REPLICATED),
    ("*ln_*.weight", REPLICATED), ("*ln_*.bias", REPLICATED),
    ("*ln1.weight", REPLICATED), ("*ln1.bias", REPLICATED),
    ("*ln2.weight", REPLICATED), ("*ln2.bias", REPLICATED),
    ("*layer_norm.weight", REPLICATED), ("*layer_norm.bias", REPLICATED),
]


def default_rules() -> ShardingRules:
    return ShardingRules(_DEFAULT_NAME_RULES, use_shape_heuristics=True)


# ------------------------------------------------------------- layout
def linear_weight_paths(model) -> set:
    """Paths of the ``nn.Linear`` weights: torch ``[out, in]``, Paddle
    ``[in, out]``."""
    from torch import nn
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def paddle_params(model):
    """``(path, Paddle-layout shape, parameter)`` for every parameter."""
    linear = linear_weight_paths(model)
    for path, p in model.named_parameters():
        shape = tuple(p.shape)
        yield path, (shape[::-1] if path in linear else shape), p


def torch_spec(spec: Tuple, transposed: bool) -> Tuple:
    """A Paddle-layout spec for the torch tensor (a linear weight's spec
    reversed)."""
    spec = _canon_spec(spec)
    if not transposed:
        return spec
    spec = spec + (None,) * (2 - len(spec))
    return tuple(reversed(spec))


# ---------------------------------------------------------- annotation
def mark_param(param, spec, opt_state_spec="__unset__"):
    """Attach a Paddle-layout sharding spec to one parameter (its
    ``dist_spec``) and bump the spec generation."""
    param.dist_spec = _canon_spec(spec) if spec is not None else None
    if opt_state_spec != "__unset__":
        param.opt_state_spec = (_canon_spec(opt_state_spec)
                                if opt_state_spec is not None else None)
    _bump_generation()
    return param


def annotate(layer, spec_map: Optional[Dict[str, Any]] = None,
             **attr_specs) -> Dict[str, Tuple]:
    """Declarative per-layer override, by direct attribute
    (``annotate(layer, weight=(None, "mp"))``) or by a glob map over the
    layer's parameter paths. Overrides beat the rule table in
    ``spec_tree``; ``None`` is an explicit replicated override."""
    recorded: Dict[str, Tuple] = {}
    for attr, spec in attr_specs.items():
        p = getattr(layer, attr, None)
        if p is None or not hasattr(p, "shape"):
            raise AttributeError(
                f"{type(layer).__name__}.{attr} is not a parameter")
        p._shard_override = _canon_spec(spec)
        recorded[attr] = p._shard_override
    if spec_map:
        named = dict(layer.named_parameters())
        for pattern, spec in spec_map.items():
            hit = False
            for path, p in named.items():
                if fnmatch.fnmatchcase(path, pattern):
                    p._shard_override = _canon_spec(spec)
                    recorded[path] = p._shard_override
                    hit = True
            if not hit:
                raise KeyError(
                    f"shard_spec pattern {pattern!r} matches no "
                    f"parameter (have e.g. "
                    f"{sorted(named)[:3]}...)")
    if recorded:
        _bump_generation()
    return recorded


# ----------------------------------------------------------- inference
def _zero_compose(spec: Tuple, shape: Sequence[int], mesh,
                  axis: str = "sharding") -> Tuple:
    """Fold ZeRO parameter sharding into a spec: dim 0 over ``axis`` where
    it divides evenly, joining an existing dim-0 sharding when the product
    still divides."""
    if not shape:
        return spec
    size = mesh.shape.get(axis, 1) if (mesh is not None
                                       and axis in mesh.axis_names) else 1
    if size <= 1:
        return spec
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    d0 = spec[0]
    if d0 is None:
        if shape[0] % size == 0:
            return (axis,) + spec[1:]
        return spec
    existing = d0 if isinstance(d0, tuple) else (d0,)
    total = size
    for a in existing:
        total *= (mesh.shape.get(a, 1)
                  if mesh is not None and a in mesh.axis_names else 1)
    if shape[0] % total == 0:
        return (existing + (axis,),) + spec[1:]
    return spec


def spec_tree(model, mesh="__global__", rules: Optional[ShardingRules]
              = None, overrides: Optional[Dict[str, Any]] = None,
              zero: Optional[str] = None) -> Dict[str, Tuple]:
    """The ``{param-path: spec}`` tree of a model, Paddle layout, with the
    reference's precedence: ``overrides``, ``annotate``, an existing
    ``dist_spec``, the rules, replication; normalized against ``mesh``
    (default: the global mesh), so no mesh or a one-slot mesh yields all
    replicated. ``zero="p_g_os"`` shards dim 0 over ``sharding``."""
    mesh = _global(mesh)
    if zero is not None and zero not in ZERO_LEVELS:
        raise ValueError(f"zero must be one of {ZERO_LEVELS}, got {zero!r}")
    rules = rules or default_rules()
    out: Dict[str, Tuple] = {}
    for path, shape, p in paddle_params(model):
        spec = None
        if overrides:
            for pattern, s in overrides.items():
                if fnmatch.fnmatchcase(path, pattern):
                    spec = _canon_spec(s)
                    break
        if spec is None:
            ov = getattr(p, "_shard_override", None)
            if ov is not None:
                spec = _canon_spec(ov)
        if spec is None:
            existing = getattr(p, "_base_dist_spec", "__unset__")
            if existing == "__unset__":
                existing = getattr(p, "dist_spec", None)
            if existing is not None:
                spec = _canon_spec(existing)
        if spec is None:
            spec = rules.spec_for(path, shape)
        spec = normalize_spec(spec, mesh, shape)
        if zero == "p_g_os":
            spec = _zero_compose(spec, shape, mesh)
        out[path] = spec
    return out


def model_spec_tree(model) -> Dict[str, Dict[str, Optional[Tuple]]]:
    """The model's current annotations (no inference)."""
    out: Dict[str, Dict[str, Optional[Tuple]]] = {}
    for path, p in model.named_parameters():
        ds = getattr(p, "dist_spec", None)
        os_ = getattr(p, "opt_state_spec", None)
        out[path] = {
            "dist_spec": _canon_spec(ds) if ds is not None else None,
            "opt_state_spec": _canon_spec(os_) if os_ is not None else None,
        }
    return out


def spec_tree_hash(specs) -> str:
    """Stable sha256 of a spec tree (any JSON-able nesting of specs)."""
    def _enc(v):
        if isinstance(v, dict):
            return {str(k): _enc(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [_enc(x) for x in v]
        return v if (v is None or isinstance(v, (str, int, float, bool))) \
            else repr(v)
    blob = json.dumps(_enc(specs), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def apply_sharding(model, mesh="__global__",
                   rules: Optional[ShardingRules] = None,
                   overrides: Optional[Dict[str, Any]] = None,
                   zero: Optional[str] = None,
                   publish: bool = True) -> Dict[str, Tuple]:
    """Compute the spec tree and write it onto the parameters
    (``dist_spec``; ``opt_state_spec`` for a ZeRO level). Returns the
    parameter spec tree."""
    mesh = _global(mesh)
    p_specs = spec_tree(model, mesh=mesh, rules=rules,
                        overrides=overrides, zero=zero)
    os_specs = p_specs if zero in (None, "p_g_os") else spec_tree(
        model, mesh=mesh, rules=rules, overrides=overrides, zero="p_g_os")
    named = dict(model.named_parameters())
    for path, spec in p_specs.items():
        p = named[path]
        if not hasattr(p, "_base_dist_spec"):
            p._base_dist_spec = getattr(p, "dist_spec", None)
        p.dist_spec = spec
        if zero is None:
            if getattr(p, "opt_state_spec", None) is not None:
                p.opt_state_spec = None
        else:
            p.opt_state_spec = os_specs[path]
    _bump_generation()
    if publish:
        publish_metrics(p_specs, named, mesh)
    return p_specs


# ----------------------------------------------------------- placement
def _is_spec_leaf(x) -> bool:
    if x is None or x == ():
        return True
    return isinstance(x, tuple) and all(
        s is None or isinstance(s, (str, tuple)) for s in x)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_spec_leaf(tree):
        out = [_tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def sharding_tree(specs, mesh="__global__"):
    """A pytree of specs as ``NamedSharding``s over the mesh (``None``
    leaves without one)."""
    from .mesh_utils import NamedSharding
    mesh = _global(mesh)
    if mesh is None:
        return _tree_map(lambda s: None, specs)
    return _tree_map(lambda s: NamedSharding(mesh, normalize_spec(s, mesh)),
                     specs)


def shard_tree(tree, specs, mesh="__global__"):
    """Place a tree of tensors by a matching tree of specs (torch layout):
    each tensor leaf a :class:`MeshTensor`; unchanged without a mesh."""
    import torch

    from .mesh_utils import MeshTensor
    mesh = _global(mesh)
    if mesh is None:
        return tree

    def _put(a, s):
        if not isinstance(a, torch.Tensor):
            return a
        return MeshTensor.place(a, mesh, s)

    if isinstance(tree, dict) and isinstance(specs, dict):
        return {k: _put(v, specs.get(k)) for k, v in tree.items()}
    return _tree_map(_put, tree, specs)


def shard_params(model, mesh="__global__",
                 specs: Optional[Dict[str, Any]] = None):
    """The model's parameters placed by their spec tree (Paddle layout; by
    default each parameter's ``dist_spec``): ``{path: MeshTensor}``. A
    torch parameter cannot hold a sharded value, so the placement is
    returned rather than written back. ``{}`` without a mesh."""
    from .mesh_utils import MeshTensor
    mesh = _global(mesh)
    if mesh is None:
        return {}
    if specs is None:
        specs = {path: getattr(p, "dist_spec", None)
                 for path, p in model.named_parameters()}
    linear = linear_weight_paths(model)
    out = {}
    for path, p in model.named_parameters():
        spec = torch_spec(specs.get(path) or (), path in linear)
        out[path] = MeshTensor.place(p.detach(), mesh, spec)
    return out


def param_shardings(mesh, named_params) -> Dict[str, Any]:
    """``{name: NamedSharding}`` from each parameter's ``dist_spec``."""
    from .mesh_utils import NamedSharding
    out = {}
    for n, p in dict(named_params).items():
        spec = normalize_spec(getattr(p, "dist_spec", None), mesh,
                              tuple(p.shape))
        out[n] = NamedSharding(mesh, spec)
    return out


# --------------------------------------------------------- constraints
def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the input batch dim shards over: dp and 'sharding'."""
    if mesh is None:
        return ()
    return tuple(a for a in ("dp", "sharding")
                 if a in mesh.axis_names and mesh.shape[a] > 1)


def batch_spec(mesh) -> Tuple:
    axes = batch_axes(mesh)
    return (axes if axes else None,)


def constrain(x, *spec, mesh="__global__"):
    """Activation sharding constraint: the identity without a live mesh;
    otherwise ``x`` placed by ``spec`` (a :class:`MeshTensor`), absent axes
    degrading to replication."""
    mesh = _global(mesh)
    if mesh is None or mesh.size <= 1:
        return x
    if len(spec) == 1 and _is_spec_leaf(spec[0]):
        spec = tuple(spec[0])
    from .mesh_utils import MeshTensor
    s = spec + (None,) * (getattr(x, "ndim", len(spec)) - len(spec))
    return MeshTensor.place(x, mesh, s)


def constrain_batch(x, mesh="__global__"):
    """Pin dim 0 to the batch axes (dp and 'sharding'); the identity
    without them or on a ragged batch."""
    mesh = _global(mesh)
    axes = batch_axes(mesh)
    if mesh is None or not axes:
        return x
    nshards = 1
    for a in axes:
        nshards *= mesh.shape[a]
    shape = tuple(getattr(x, "shape", ()))
    if not shape or shape[0] % nshards != 0:
        return x
    return constrain(x, (("dp", "sharding"),), mesh=mesh)


def constrain_seq(x, mesh="__global__"):
    """Batch over dp, sequence over 'sep'; the identity without a sep
    axis."""
    mesh = _global(mesh)
    if mesh is None or "sep" not in mesh.axis_names \
            or mesh.shape["sep"] == 1:
        return x
    return constrain(x, "dp", "sep", mesh=mesh)


# ------------------------------------------------------- observability
def projected_bytes_per_chip(named_params, specs: Dict[str, Tuple],
                             mesh_axes: Dict[str, int],
                             opt_bytes_per_param: int = 0,
                             opt_specs: Optional[Dict[str, Tuple]] = None
                             ) -> Dict[str, int]:
    """Per-slot model-state bytes on a target topology (``{axis:
    degree}``): each parameter's bytes divided by its spec's shard count
    (a count, so a linear weight's torch layout does not change it);
    ``opt_bytes_per_param`` adds optimizer state laid out by ``opt_specs``
    (default: the parameter specs)."""
    import numpy as np
    param_b = 0
    opt_b = 0
    for name, p in dict(named_params).items():
        shape = tuple(p.shape)
        n_elem = int(np.prod(shape)) if shape else 1
        itemsize = int(p.element_size())
        spec = specs.get(name, REPLICATED)
        param_b += (n_elem * itemsize) // max(_spec_shards(
            spec, mesh_axes), 1)
        if opt_bytes_per_param:
            ospec = (opt_specs or specs).get(name, spec)
            if getattr(p, "requires_grad", True):
                opt_b += (n_elem * opt_bytes_per_param) // max(
                    _spec_shards(ospec, mesh_axes), 1)
    return {"param_bytes": int(param_b), "opt_bytes": int(opt_b),
            "total_bytes": int(param_b + opt_b)}


def _get_metrics():
    global _metrics
    with _lock:
        if _metrics is None:
            from ..observability.registry import default_registry
            reg = default_registry()
            _metrics = {
                "info": reg.gauge(
                    "paddle_shard_spec_tree_info",
                    "Spec-tree identity of the live process's sharding "
                    "(value 1; the hash label identifies the tree)",
                    labelnames=("hash",)),
                "sharded": reg.gauge(
                    "paddle_shard_spec_params_sharded",
                    "Parameters carrying a non-replicated spec"),
                "replicated": reg.gauge(
                    "paddle_shard_spec_params_replicated",
                    "Parameters whose spec is fully replicated"),
                "projected": reg.gauge(
                    "paddle_shard_projected_bytes_per_chip",
                    "Projected per-chip model-state bytes from the "
                    "spec tree on the current mesh",
                    labelnames=("component",)),
            }
        return _metrics


def publish_metrics(specs: Dict[str, Tuple], named_params,
                    mesh) -> None:
    """Export the spec tree: identity hash, sharded/replicated counts,
    per-slot projected bytes on ``mesh`` (skipped without one)."""
    m = _get_metrics()
    h = spec_tree_hash(specs)
    m["info"].clear()
    m["info"].labels(hash=h).set(1)
    sharded = sum(1 for s in specs.values()
                  if any(a is not None for a in s))
    m["sharded"].set(sharded)
    m["replicated"].set(len(specs) - sharded)
    if mesh is not None:
        axes = {str(k): int(v) for k, v in dict(mesh.shape).items()}
        proj = projected_bytes_per_chip(named_params, specs, axes)
        m["projected"].labels(component="params").set(
            proj["param_bytes"])
        m["projected"].labels(component="total").set(
            proj["total_bytes"])
