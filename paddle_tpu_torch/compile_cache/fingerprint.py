"""Stable cache keys for the persistent compile cache (the port of
``paddle_tpu/compile_cache/fingerprint.py``).

A cached first-dispatch record is only reusable when EVERYTHING that
shaped the measurement is identical: the Python that ran (function and
model source), the constants it reads (closure cells, referenced globals,
helper-function bodies, layer constructor hyperparameters), the operands'
shapes and dtypes, the compile-relevant ``FLAGS_*`` values, and the
toolchain: torch and CUDA versions, the card, the kernel library's
source hash and torch's float32 matmul settings. The key is a sha256 over
a canonical JSON of all of the above, so a key collision requires a
semantically identical dispatch.

Fingerprints never run the model: everything here is derived from source
text, object structure and flag values alone. The environment walk
(``_callable_fp``) is depth-bounded: constants reachable only through
more than ``_MAX_DEPTH`` levels of helper calls fall out of the key,
erring toward a spurious MISS (a fresh measurement), never a false hit.
Tensors are described by shape and dtype, never by their values: the
records hold FLOPs, bytes and memory, which the values do not change. The
remaining deliberate gap is state a dispatch reads from outside the
function/layer object graph entirely (a file, an environment variable):
fold it into the key via ``cache_key(extra=...)``.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import types
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "cache_key", "function_fingerprint", "layer_fingerprint",
    "mesh_fingerprint", "environment_fingerprint",
    "compile_relevant_flags", "mark_compile_relevant", "bytes_fingerprint",
    "avals_signature",
]

# Flags whose value changes what a dispatch computes (not just runtime
# behavior), with the reference's set; a flag the port does not define is
# skipped. Subsystems that add such a flag register it with
# ``mark_compile_relevant`` so stale records can never be served across a
# flag flip.
_COMPILE_RELEVANT_FLAGS = {
    "FLAGS_tpu_matmul_precision",
    "FLAGS_use_autotune",
    "FLAGS_flash_min_seqlen",
    "FLAGS_flash_block_q",
    "FLAGS_flash_block_k",
    "FLAGS_cudnn_deterministic",
    "FLAGS_serving_donate_inputs",
}


def mark_compile_relevant(name: str) -> str:
    """Register a flag as compile-relevant: its live value becomes part
    of every cache key, so changing it invalidates cached records."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    _COMPILE_RELEVANT_FLAGS.add(name)
    return name


def compile_relevant_flags() -> Dict[str, Any]:
    """Live values of every compile-relevant flag (missing ones are
    skipped so the key survives flag-set evolution across versions)."""
    from ..framework.flags import flag_value
    out = {}
    for name in sorted(_COMPILE_RELEVANT_FLAGS):
        try:
            out[name] = flag_value(name)
        except KeyError:
            continue
    return out


def _sha(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str) else p)
        h.update(b"\x00")
    return h.hexdigest()


def bytes_fingerprint(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# How many levels of (closure / global / callee) indirection the
# fingerprint walk follows before describing a value by type alone.
_MAX_DEPTH = 3

_PRIMITIVES = (type(None), bool, int, float, complex, str, bytes)


def _const_token(c) -> str:
    """repr of one co_consts entry, with nested code objects replaced
    by a bytecode hash — their default repr embeds a memory address,
    which would key the same lambda apart across processes."""
    if isinstance(c, types.CodeType):
        return "code:" + hashlib.sha256(c.co_code).hexdigest()
    return repr(c)


def _collect_global_names(code, out: set):
    out.update(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _collect_global_names(c, out)


def _tensor_desc(v) -> Optional[str]:
    """Shape and dtype of a tensor or array (a Paddle ``Tensor`` by its
    ``_data``); None for anything else."""
    data = getattr(v, "_data", None)
    if data is not None and hasattr(data, "shape") \
            and hasattr(data, "dtype"):
        v = data
    if hasattr(v, "shape") and hasattr(v, "dtype") \
            and not isinstance(v, type):
        try:
            shape = tuple(int(d) for d in v.shape)
        except (TypeError, ValueError):
            shape = tuple(v.shape)
        return f"tensor:{shape}:{str(v.dtype).replace('torch.', '')}"
    return None


def _value_desc(v, seen: set, depth: int) -> str:
    """Deterministic description of a constant a dispatch reads:
    primitives by repr, tensors and arrays by shape and dtype, callables
    by recursive fingerprint, containers element-wise; anything whose repr
    would be address-dependent degrades to its type identity (a spurious
    miss, never a false hit)."""
    if isinstance(v, _PRIMITIVES):
        return repr(v)
    if depth <= 0:
        return f"deep:{type(v).__module__}.{type(v).__qualname__}"
    if isinstance(v, types.ModuleType):
        return f"mod:{v.__name__}"
    if isinstance(v, type):
        parts = [f"{v.__module__}.{v.__qualname__}"]
        try:
            parts.append(inspect.getsource(v))
        except (OSError, TypeError):
            pass
        return "cls:" + _sha(parts)
    desc = _tensor_desc(v)
    if desc is not None:
        return desc
    if callable(v):
        return "fn:" + _callable_fp(v, seen, depth)
    if isinstance(v, dict):
        items = sorted((repr(k), _value_desc(val, seen, depth - 1))
                       for k, val in v.items())
        return "{" + ",".join(f"{k}:{d}" for k, d in items) + "}"
    if isinstance(v, (list, tuple)):
        body = ",".join(_value_desc(x, seen, depth - 1) for x in v)
        return ("[" if isinstance(v, list) else "(") + body + \
            ("]" if isinstance(v, list) else ")")
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(
            sorted(_value_desc(x, seen, depth - 1) for x in v)) + "}"
    r = repr(v)
    if " at 0x" in r or (r.startswith("<") and "0x" in r):
        return f"obj:{type(v).__module__}.{type(v).__qualname__}"
    return f"obj:{type(v).__module__}.{type(v).__qualname__}:{r}"


def _callable_fp(fn, seen: set, depth: int) -> str:
    """Recursive identity of a callable: qualified name + source text
    (bytecode + consts for source-less callables), plus — down to
    ``depth`` — the closure cell values, the referenced globals, and
    thereby the bodies of the helper functions it calls. ``seen`` keys
    on code objects so mutual recursion terminates."""
    fn = inspect.unwrap(fn)
    target = getattr(fn, "__func__", fn)       # bound method -> function
    qual = getattr(target, "__qualname__", None) \
        or getattr(target, "__name__", None) or repr(type(target))
    label = f"{getattr(target, '__module__', '') or ''}.{qual}"
    code = getattr(target, "__code__", None)
    if code is None:
        return f"builtin:{label}"
    if code in seen:
        return f"rec:{label}"
    seen.add(code)
    parts = [label]
    if target.__name__ == "<lambda>":
        # getsource on a lambda returns the whole surrounding statement,
        # so two identical lambdas on different lines would key apart —
        # the compiled code object is the lambda's real identity
        parts.append(code.co_code.hex())
        parts.append(",".join(_const_token(c) for c in code.co_consts))
        parts.append(repr(code.co_names))
    else:
        try:
            parts.append(inspect.getsource(target))
        except (OSError, TypeError):
            parts.append(code.co_code.hex())
            parts.append(",".join(_const_token(c) for c in code.co_consts))
    if depth > 0:
        cells = getattr(target, "__closure__", None) or ()
        for name, cell in zip(code.co_freevars, cells):
            try:
                val = cell.cell_contents
            except ValueError:           # not yet filled
                parts.append(f"cell:{name}:<unset>")
                continue
            parts.append(f"cell:{name}:{_value_desc(val, seen, depth - 1)}")
        names: set = set()
        _collect_global_names(code, names)
        g = getattr(target, "__globals__", None) or {}
        for name in sorted(names & set(g)):
            parts.append(f"g:{name}:{_value_desc(g[name], seen, depth - 1)}")
    return _sha(parts)


def function_fingerprint(fn) -> str:
    """Identity hash of a Python callable: qualified name + source text
    (falling back to bytecode + consts for source-less callables, e.g.
    lambdas defined in a REPL), PLUS its environment — closure cell
    values, referenced module-level globals, and (recursively,
    depth-bounded) the bodies of helper functions it calls. Changing any
    of these changes what a dispatch runs, so it must change the key."""
    return _sha(["fnv2", _callable_fp(fn, set(), _MAX_DEPTH)])


# Module bookkeeping that is keyed elsewhere or changes nothing a dispatch
# computes: parameters, buffers and submodules are covered structurally
# below, ``training`` is keyed by every call site, and the hook tables are
# keyed by their functions (their handle ids are process-local counters).
_LAYER_INFRA = {"_parameters", "_buffers", "_modules", "_sub_layers",
                "training", "_non_persistent_buffers_set"}
_HOOK_TABLES = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks",
                "_backward_pre_hooks", "_state_dict_hooks",
                "_state_dict_pre_hooks", "_load_state_dict_pre_hooks",
                "_load_state_dict_post_hooks",
                "_forward_hooks_with_kwargs", "_forward_hooks_always_called",
                "_forward_pre_hooks_with_kwargs")


def _module_cfg(sub) -> str:
    out = []
    for k, v in sorted(vars(sub).items()):
        if k in _LAYER_INFRA:
            continue
        if k in _HOOK_TABLES and isinstance(v, dict):
            v = [fn for fn in v.values() if callable(fn)]
            if not v:
                continue
        out.append(f"{k}={_value_desc(v, set(), 2)}")
    return ";".join(out)


def layer_fingerprint(layer) -> str:
    """Identity hash of a module tree (``torch.nn.Module``, the Paddle
    ``nn.Layer`` among them): the class source of the module and every
    distinct submodule class, the forward's function fingerprint, the
    per-instance configuration (constructor hyperparameters such as
    stride, epsilon or rate, registered hooks, and any other
    non-parameter attribute, tensors by shape and dtype), per submodule
    path, plus the parameter and buffer structure (names, shapes, dtypes,
    whether each takes a gradient). Never the values: they ride as
    operands."""
    seen_cls, parts = set(), []
    named = getattr(layer, "named_modules", None)
    subs = list(named()) if named is not None else [("", layer)]
    for path, sub in subs:
        cls = type(sub)
        if cls not in seen_cls:
            seen_cls.add(cls)
            parts.append(f"{cls.__module__}.{cls.__qualname__}")
            try:
                parts.append(inspect.getsource(cls))
            except (OSError, TypeError):
                pass
            fwd = getattr(cls, "forward", None)
            if fwd is not None:
                parts.append("fwd:" + _callable_fp(fwd, set(), _MAX_DEPTH))
        parts.append(f"cfg:{path}:{cls.__qualname__}:{_module_cfg(sub)}")
    for name, p in layer.named_parameters():
        parts.append(f"p:{name}:{tuple(p.shape)}:"
                     f"{str(p.dtype).replace('torch.', '')}:"
                     f"{bool(p.requires_grad)}")
    for name, b in layer.named_buffers():
        if b is not None:
            parts.append(f"b:{name}:{tuple(b.shape)}:"
                         f"{str(b.dtype).replace('torch.', '')}")
    return _sha(parts)


_GLOBAL_MESH = "__global__"


def mesh_fingerprint(mesh) -> str:
    """Canonical description of the device mesh a dispatch ran over:
    ``"none"`` for no mesh (the reference's token); for a
    ``distributed.mesh_utils.Mesh`` its axes and degrees, its slots'
    devices and their count (two meshes of the same axes over other slots
    never share a key)."""
    if mesh is None:
        return "none"
    try:
        return json.dumps({"axes": {str(k): int(v)
                                    for k, v in dict(mesh.shape).items()},
                           "slots": [str(d) for d in mesh.slots],
                           "n": int(mesh.size)}, sort_keys=True)
    except Exception:  # noqa: BLE001 - an exotic mesh still needs A key
        return repr(mesh)


_static_env: Optional[Dict[str, Any]] = None


def environment_fingerprint() -> Dict[str, Any]:
    """Toolchain + device identity: an entry written by another torch,
    CUDA, card, kernel library or float32 matmul setting must never
    load. The versions, the card and the library's source hash are read
    once a process; the two matmul settings live."""
    global _static_env
    import torch
    if _static_env is None:
        from ..ops import _build
        try:
            if torch.cuda.is_available():
                kind = torch.cuda.get_device_name(0)
                n = torch.cuda.device_count()
            else:
                kind, n = "cpu", 0
        except Exception:  # noqa: BLE001 - a failed CUDA init: keyable
            kind, n = "unavailable", 0
        _static_env = {"torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "device_kind": kind,
                       "n_devices": n,
                       "kernel_library": _build.library_hash()}
    return dict(_static_env,
                allow_tf32=bool(torch.backends.cuda.matmul.allow_tf32),
                matmul_precision=torch.get_float32_matmul_precision())


def _leaf_desc(x) -> list:
    """Canonical (shape, dtype, weak_type, sharding-spec) of one operand
    leaf, as the reference's: torch tensors, numpy arrays, tensor specs
    and scalars (the port has no weak types and no shardings)."""
    shape = [str(d) for d in tuple(getattr(x, "shape", ()))]
    dtype = str(getattr(x, "dtype", type(x).__name__)).replace("torch.", "")
    return [shape, dtype, False, ""]


def avals_signature(tree) -> list:
    """Abstract signature of an operand pytree: per-leaf descriptors
    plus the tree structure (two different dict layouts with the same
    leaves must not collide)."""
    from torch.utils._pytree import tree_flatten
    leaves, spec = tree_flatten(tree)
    return [[_leaf_desc(leaf) for leaf in leaves], str(spec)]


def cache_key(fn_fingerprint: str, args=None, *, mesh=_GLOBAL_MESH,
              extra: Optional[dict] = None) -> Tuple[str, dict]:
    """The full persistent-cache key: sha256 hex digest plus the parts
    dict it was computed from (stored alongside the entry for
    debugging). ``mesh`` defaults to the process's global mesh
    (``distributed.mesh_utils``); pass ``None`` explicitly for a dispatch
    known to be meshless."""
    if isinstance(mesh, str) and mesh == _GLOBAL_MESH:
        from ..distributed.mesh_utils import get_global_mesh
        mesh = get_global_mesh()
    parts = {
        "v": 1,
        "fn": fn_fingerprint,
        "args": avals_signature(args) if args is not None else None,
        "mesh": mesh_fingerprint(mesh),
        "flags": compile_relevant_flags(),
        "env": environment_fingerprint(),
        "extra": extra,
    }
    blob = json.dumps(parts, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest(), parts
