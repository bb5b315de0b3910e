"""``inference`` of the port: ``Config`` / ``Predictor`` (the counterpart of
``paddle_tpu/inference/__init__.py``).

A ``Predictor`` loads the port's artifact (``<prefix>.pt2``, written by
``jit.save``; ``framework/exporting.py``) onto a device and runs it: the
card by default, the CPU after ``Config.disable_gpu()``; without a CUDA
device and without that call, creating it raises. The ``Config`` surface
keeps the reference's toggle names, accepted as no-ops where the reference
accepts them (its IR passes, memory optimisation, TensorRT, MKLDNN).

On the card a Predictor runs on a CUDA stream of its own:
``dispatch_many`` copies the inputs to the device without blocking (from
pinned host memory when the caller hands it pinned tensors, as the serving
layer's staging buffers are), runs the program, enqueues the outputs' copy
into pinned host tensors and records a CUDA event, and returns before the
card finishes; ``_PendingBatch.block`` waits on that event and
``fetch_many`` slices the host outputs per request. ``run`` is the same,
synchronously. Outputs cross to numpy. numpy has no bfloat16 of its own:
a bf16 output comes back as an ``ml_dtypes`` bfloat16 array of the same
bits, as the reference hands it out, or as float32 where ``ml_dtypes``
does not import.

Left out, each raising ``NotImplementedError`` that names its ROADMAP
queue 1 item: ``Config.set_precision(Half | Bfloat16)``, which the
reference re-lowers from its ``.pdmodel`` program (item 5d; serve a model
saved after ``amp.decorate`` instead); the reference's ``.pdmodel`` /
``.pdiparams`` pair and StableHLO ``.pdexec`` (item 5d).

``attach_serving_mesh`` takes a ``serving.mesh.ServingMesh`` (the fleet
worker attaches ``FLAGS_serving_mesh_mp``'s): a live mesh's axes, slots and
the weights' spec-tree hash join the artifact's identity and every
compile-cache key, and the replica reports the mesh. The exported program
is one graph, and this slice does not partition it: it runs on the
predictor's device (the mesh's first slot) with its full weights. Splitting
an exported program over the slots waits for ROADMAP queue 1 item 5c, part
2; the decode engine's tensor-parallel path (``CachedDecoder(mesh=)``) is
the one that runs per slot.

The persistent compile cache (``compile_cache/``, on when
``FLAGS_compile_cache_dir`` is set) serves the dispatch site ``serving``,
keyed on ``artifact_fingerprint`` plus the assembled batch's shapes and
dtypes (reference ``:541-590``): a fresh Predictor on a warm directory
loads each signature's first-dispatch record instead of measuring it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch

try:
    import ml_dtypes
except ImportError:
    ml_dtypes = None

from ..framework.device import resolve_device
from ..framework.exporting import SUFFIX, load_artifact

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType", "get_version"]

_REFERENCE_FORMATS = (".pdmodel", ".pdexec")


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    TPU = 3
    CUSTOM = 4


def _reference_format(path):
    return NotImplementedError(
        f"{path}: the reference's .pdmodel/.pdiparams and .pdexec "
        f"artifacts wait for ROADMAP queue 1 item 5d; save the model with "
        f"paddle_tpu_torch.jit.save (a {SUFFIX} artifact)")


class Config:
    """AnalysisConfig's surface over the port's artifact: the model path
    (a prefix, a ``.pt2`` file or a directory holding one), the device and
    the reference's toggles."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self._prefix = None
        self._flags: Dict[str, object] = {}
        self._precision = PrecisionType.Float32
        self._device: Optional[str] = None      # None: the CUDA device
        if model_path is not None:
            self._set_paths(model_path, params_path)

    def _set_paths(self, model_path, params_path=None):
        model_path = str(model_path)
        if params_path is not None or model_path.endswith(_REFERENCE_FORMATS):
            raise _reference_format(model_path)
        model_path = model_path.removesuffix(SUFFIX)
        if os.path.isdir(model_path):
            names = os.listdir(model_path)
            cands = sorted(f[:-len(SUFFIX)] for f in names
                           if f.endswith(SUFFIX))
            if not cands:
                if any(f.endswith(_REFERENCE_FORMATS) for f in names):
                    raise _reference_format(model_path)
                raise ValueError(f"no {SUFFIX} artifact under {model_path}")
            model_path = os.path.join(model_path, cands[0])
        self._prefix = model_path

    # ---- model location ----
    def set_model(self, model_path, params_path=None):
        """Set the path only; flags, precision and device survive."""
        self._set_paths(model_path, params_path)

    def model_dir(self):
        return os.path.dirname(self._prefix or "")

    def prog_file(self):
        return (self._prefix or "") + SUFFIX

    def params_file(self):
        # the weights live inside the program's file
        return self.prog_file()

    # ---- device selection ----
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_tpu(self):
        # the accelerator the reference meant is the card here
        self._device = None

    def use_gpu(self):
        return self._device != "cpu"

    def set_cpu_math_library_num_threads(self, n):
        self._flags["cpu_threads"] = n

    # ---- toggles the reference accepts as no-ops (recorded) ----
    def _noop(self, name, value=True):
        self._flags[name] = value

    def switch_ir_optim(self, x=True):
        self._noop("ir_optim", x)

    def switch_ir_debug(self, x=True):
        self._noop("ir_debug", x)

    def enable_memory_optim(self, x=True):
        self._noop("memory_optim", x)

    def switch_use_feed_fetch_ops(self, x=True):
        self._noop("feed_fetch_ops", x)

    def switch_specify_input_names(self, x=True):
        self._noop("specify_input_names", x)

    def enable_mkldnn(self):
        self._noop("mkldnn")

    def disable_glog_info(self):
        self._noop("glog_off")

    def enable_profile(self):
        self._noop("profile")

    def set_optim_cache_dir(self, d):
        self._noop("optim_cache_dir", d)

    def enable_tensorrt_engine(self, **kw):
        self._noop("tensorrt", kw)

    def enable_low_precision_io(self, x=True):
        self._noop("low_precision_io", x)

    # ---- precision ----
    def set_precision(self, precision):
        self._precision = precision

    def precision(self):
        return self._precision

    def summary(self) -> str:
        lines = [f"model prefix: {self._prefix}",
                 f"device: {self._device or 'cuda'}",
                 f"precision: {self._precision}"]
        lines += [f"{k}: {v}" for k, v in self._flags.items()]
        return "\n".join(lines)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if ml_dtypes is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class Tensor:
    """Input/output handle (the reference's ZeroCopyTensor): inputs hold a
    host copy, outputs of the handle flow (``run()`` without arguments) a
    device tensor that ``copy_to_cpu`` fetches."""

    def __init__(self, name: str, spec=None):
        self.name = name
        self._spec = spec
        self._value = None

    def copy_from_cpu(self, arr):
        # a copy, as the reference's (the feed cache keys on identity)
        self._value = np.array(arr)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"tensor '{self.name}' has no value yet")
        if isinstance(self._value, torch.Tensor):
            return _to_numpy(self._value)
        return np.array(self._value)

    def reshape(self, shape):
        # declare the input shape ahead of copy_from_cpu; a new shape
        # always wins (a numel change drops the stale value)
        if self._value is not None and \
                int(np.prod(shape)) == int(np.prod(self._value.shape)):
            self._value = self._value.reshape(tuple(shape))
            return
        self._value = None
        self._spec = dict(self._spec or {}, shape=list(shape))

    @property
    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._spec["shape"]) if self._spec else None

    def type(self):
        if self._value is not None:
            return str(self._value.dtype).removeprefix("torch.")
        return self._spec["dtype"] if self._spec else None


class _PendingBatch:
    """Result of ``Predictor.dispatch_many``: the host output tensors
    (still being written on the card until ``done`` fires), the
    per-request row counts, and two CUDA events (None on the CPU):
    ``inputs_done`` after the inputs' host-to-device copy (the host
    buffers may be reused once it fires) and ``done`` after the outputs'
    device-to-host copy."""

    __slots__ = ("outs", "rows", "total", "inputs_done", "done")

    def __init__(self, outs, rows, inputs_done=None, done=None):
        self.outs = outs
        self.rows = rows
        self.total = sum(rows)
        self.inputs_done = inputs_done
        self.done = done

    def block(self):
        """Wait until the outputs are on the host."""
        if self.done is not None:
            self.done.synchronize()
        return self


class Predictor:
    """AnalysisPredictor's surface over the port's artifact."""

    def __init__(self, config: Config):
        if config._prefix is None:
            raise ValueError("Config has no model path")
        if config.precision() in (PrecisionType.Half,
                                  PrecisionType.Bfloat16):
            raise NotImplementedError(
                "Config.set_precision(Half/Bfloat16) re-lowers the "
                "reference's .pdmodel program, which waits for ROADMAP "
                "queue 1 item 5d; serve a model cast with amp.decorate and "
                "saved with jit.save instead")
        if config.precision() == PrecisionType.Int8:
            raise NotImplementedError(
                "Int8 serving goes through the static PTQ pipeline "
                "(quantization, ROADMAP queue 1 item 5d), not "
                "Config.set_precision")
        if config.precision() != PrecisionType.Float32:
            raise ValueError(f"set_precision expects a PrecisionType "
                             f"member, got {config.precision()!r}")
        self._config = config
        self._device = resolve_device(config._device)
        self._artifact = load_artifact(config._prefix, self._device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._inputs = {name: Tensor(name, spec)
                        for name, spec in zip(self._artifact.feed_names,
                                              self._artifact.feeds)}
        self._feed_cache: Dict[str, tuple] = {}
        # output handles are stable per fetch name: a host that fetched a
        # handle before the first run reads the current run's result
        self._output_handles: Dict[str, Tensor] = {}
        self._fingerprint: Optional[str] = None
        # xstats memo: assembled-batch shapes -> ExecEntry
        self._xstats_memo: Dict[tuple, object] = {}
        # the last dispatch's compile-cache result ("hit", "miss", or None
        # when it did not ask the cache), by site
        self.cache_outcomes: Dict[str, Optional[str]] = {}
        # the attached serving mesh (None: single-shard) and the weights'
        # spec-tree hash under it
        self._serving_mesh = None
        self._weight_spec_hash: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _place(self, a) -> torch.Tensor:
        """A host array or tensor on the device (without blocking from
        pinned memory; on the CPU, a tensor over the array's memory)."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self._device, non_blocking=True)

    def _copy_out(self, outs):
        """The outputs on the host: on the card, copies into pinned
        tensors enqueued on the stream and the event after them."""
        if self._stream is None:
            return [o.detach() for o in outs], None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                .copy_(o, non_blocking=True) for o in outs]
        done = torch.cuda.Event()
        done.record(self._stream)
        return host, done

    def _forward(self, xs):
        """One dispatch of the program (site ``serving``): the first of
        each assembled-batch signature is measured and registered by
        xstats (``observability/xstats.py``), as the reference registers
        it (``inference/__init__.py:594-640``), or loaded from the compile
        cache when one is set. The signature leads with the reference's
        donation tag, always 0 here: torch donates nothing."""
        from ..observability import xstats
        key = tuple((tuple(a.shape), str(a.dtype)) for a in xs)
        return xstats.observed_call(
            self._xstats_memo, key, "serving",
            lambda: self._artifact(*xs),
            signature_fn=lambda: ((((0,), "donate"),)
                                  + xstats.signature_of(list(xs))),
            kind="serving", fingerprint=self.artifact_fingerprint,
            device=self._device, identity=self._cache_identity,
            outcome=self.cache_outcomes,
            mesh=(self._serving_mesh.mesh_for_cache_key()
                  if self._serving_mesh is not None else None))

    def _cache_identity(self) -> str:
        """The compile-cache identity: the artifact's fingerprint, and
        under a live mesh its weights' spec-tree hash."""
        if self._weight_spec_hash is None:
            return self.artifact_fingerprint()
        return self.artifact_fingerprint() + ":" + self._weight_spec_hash

    # ---- reference Predictor API ----
    def get_input_names(self) -> List[str]:
        return list(self._artifact.feed_names)

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def get_input_tensor(self, name: str) -> Tensor:  # legacy alias
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """With ``inputs``: run them and return the outputs as numpy
        arrays. Without: run the input handles' values and leave the
        outputs in the output handles (on the device until
        ``copy_to_cpu``); returns True."""
        if inputs is not None:
            for name, arr in zip(self._artifact.feed_names, inputs):
                self._inputs[name].copy_from_cpu(arr)
        with self._on_stream():
            arrays = []
            for name in self._artifact.feed_names:
                h = self._inputs[name]
                if h._value is None:
                    raise RuntimeError(f"input '{name}' not set")
                # a value already on the device is reused (identity of
                # the handle's host copy)
                hit = self._feed_cache.get(name)
                if hit is not None and hit[0] is h._value:
                    arrays.append(hit[1])
                    continue
                placed = self._place(h._value)
                self._feed_cache[name] = (h._value, placed)
                arrays.append(placed)
            outs = self._forward(arrays)
            if inputs is not None:
                host, done = self._copy_out(outs)
        if inputs is not None:
            if done is not None:
                done.synchronize()
            values = [_to_numpy(h) for h in host]
            for i, v in enumerate(values):
                self._fetch_handle(f"fetch_{i}")._value = v
            return [np.array(v) for v in values]
        if self._stream is not None:
            self._stream.synchronize()
        for i, o in enumerate(outs):
            self._fetch_handle(f"fetch_{i}")._value = o
        return True

    def run_many(self, feeds_list):
        """``feeds_list``: per-request feed lists (each ordered like the
        feed names, identical non-batch shapes), concatenated along axis 0,
        run as one dispatch and sliced back per request by their row
        counts."""
        pending = self.dispatch_many(feeds_list)
        return [] if pending is None else self.fetch_many(pending)

    def dispatch_many(self, feeds_list=None, *, assembled=None, rows=None,
                      donate=False):
        """Copy and dispatch one batch without waiting for its results,
        returning a ``_PendingBatch`` for ``fetch_many``. Either
        ``feeds_list`` (per-request feed lists, concatenated here) or
        ``assembled`` (per-feed host arrays or tensors already batched,
        with ``rows`` the per-request row counts: the serving layer's
        staging buffers) supplies the inputs. ``donate`` is accepted and
        has no effect: torch has no buffer donation, and the port behaves
        as the reference does on its CPU backend, which does not donate
        (``FLAGS_serving_donate_inputs``)."""
        if assembled is None:
            if not feeds_list:
                return None
            per_req = [[a if type(a) is np.ndarray else np.asarray(a)
                        for a in feeds] for feeds in feeds_list]
            rows = [int(r[0].shape[0]) if r[0].ndim else 1 for r in per_req]
            assembled = []
            for i in range(len(self._artifact.feed_names)):
                parts = [r[i] for r in per_req]
                assembled.append(parts[0] if len(parts) == 1
                                 else np.concatenate(parts, axis=0))
        with self._on_stream():
            xs = [self._place(a) for a in assembled]
            inputs_done = None
            if self._stream is not None:
                inputs_done = torch.cuda.Event()
                inputs_done.record(self._stream)
            host, done = self._copy_out(self._forward(xs))
        return _PendingBatch(host, list(rows), inputs_done, done)

    def fetch_many(self, pending: _PendingBatch):
        """The outputs of a ``_PendingBatch`` as numpy arrays (after
        waiting for them), sliced back per request by row count; an output
        without a leading axis of the batch's rows goes to every request
        whole."""
        pending.block()
        host = [_to_numpy(h) for h in pending.outs]
        total = pending.total
        results = []
        ofs = 0
        for r in pending.rows:
            results.append([h[ofs:ofs + r] if h.ndim and h.shape[0] == total
                            else h for h in host])
            ofs += r
        return results

    def _fetch_handle(self, name: str) -> Tensor:
        t = self._output_handles.get(name)
        if t is None:
            t = self._output_handles[name] = Tensor(name)
        return t

    def get_output_names(self) -> List[str]:
        return [f"fetch_{i}" for i in range(self._artifact.n_outputs)]

    def get_output_handle(self, name: str) -> Tensor:
        return self._fetch_handle(name)

    def get_output_tensor(self, name: str) -> Tensor:  # legacy alias
        return self.get_output_handle(name)

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass

    def artifact_fingerprint(self) -> str:
        """Stable identity of the loaded program, as the reference defines
        it: sha256 of the saved program (the serialized graph of the
        ``.pt2`` archive, where the reference hashes its StableHLO, and
        the port's record of feeds and outputs) plus the weight layout
        (names, shapes, dtypes; weight values are not program identity).
        The same file gives the same fingerprint in any process."""
        if self._fingerprint is None:
            import hashlib
            import zipfile
            h = hashlib.sha256()
            with zipfile.ZipFile(self._artifact.path) as z:
                for name in sorted(z.namelist()):
                    parts = name.split("/")
                    if "models" in parts[:-1] or "extra" in parts[:-1]:
                        h.update(name.split("/", 1)[-1].encode())
                        h.update(z.read(name))
            program = self._artifact.program
            layout = dict(program.state_dict)
            layout.update(program.constants)
            for n in sorted(layout):
                w = layout[n]
                if isinstance(w, torch.Tensor):
                    h.update(f"{n}:{tuple(w.shape)}:{w.dtype}".encode())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    def attach_serving_mesh(self, mesh):
        """Attach a serving mesh (reference ``inference/__init__.py:
        363-409``): the weights' spec tree through the ``distributed.
        shard`` rule tables over the program's weight names, its hash and
        the mesh joining the compile-cache key, every memo dropped. An
        inert mesh (None, one slot) restores the single-shard identity
        exactly. The program itself runs on this predictor's device (see
        the module's docstring). Returns self."""
        from ..distributed.shard import (default_rules, normalize_spec,
                                         spec_tree_hash)
        from ..serving.mesh import ServingMesh
        smesh = mesh if isinstance(mesh, ServingMesh) else ServingMesh(mesh)
        self._serving_mesh = smesh
        self._weight_spec_hash = None
        self._xstats_memo = {}
        self._feed_cache = {}
        if not smesh.live:
            return self
        rules = default_rules()
        program = self._artifact.program
        specs = {}
        for n in sorted(program.state_dict):
            w = program.state_dict[n]
            specs[n] = normalize_spec(rules.spec_for(n, tuple(w.shape)),
                                      smesh.mesh, tuple(w.shape))
        self._weight_spec_hash = spec_tree_hash(specs)
        return self

    @property
    def serving_mesh(self):
        return self._serving_mesh


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def get_version() -> str:
    from .. import __version__
    return __version__
