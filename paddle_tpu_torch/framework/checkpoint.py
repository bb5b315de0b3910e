"""Crash-safe checkpoint directories: the port of
``paddle_tpu/framework/checkpoint.py``, the durable layer under
``paddle_tpu_torch.elastic.CheckpointManager``.

The on-disk format is the reference's, so either package's
``load_sharded`` reads the other's directories::

  meta.json    {"format": 2, "entries": {name: {shape, dtype, spec,
                file, sha256[, stored_as]}}}   (written LAST)
  extra.json   optional JSON sidecar (training state, RNG scalars)
  <file>.npy   one full array per entry

``spec`` is the entry's sharding spec: a ``distributed.mesh_utils.
MeshTensor``'s own, or a tensor's ``dist_spec`` attribute, else ``null``.
A placed tensor is gathered to one full array on save, as the reference's
arrays are. ``load_sharded(mesh=...)`` (default: the global mesh) places
each entry whose spec is recorded by it, a ``MeshTensor``; entries without
a spec, or without a mesh, load as CPU tensors carrying their recorded
spec as ``dist_spec``.

The crash-safety protocol is the reference's:

- **host snapshot before return**: every tensor is copied to host memory
  before ``save_sharded`` returns, so an in-place update by the next
  optimizer step cannot reach the checkpoint. CUDA tensors are copied on
  a stream of the snapshot's own, ordered after the work already queued
  on the caller's stream, into a page-locked host buffer of exactly the
  snapshot's size that the caller keeps for its next save (the manager's
  own), or into pageable memory of the call's own;
- **the writer hashes**: the reference hashes every array on the caller's
  thread. Here the sha256 of each entry is taken where it is written (the
  writer thread of an async save, a few worker threads at a time:
  ``hashlib`` releases the GIL on large buffers), so the caller's stall is
  the device-to-host copy alone. The manifest still carries every digest,
  because ``meta.json`` is written last;
- **staged atomic commit**: every file goes into ``<path>.tmp-<token>``,
  each fsync'd, ``meta.json`` last, the directory fsync'd, then one
  ``os.replace`` onto the final path. A ``kill -9`` at any instant leaves
  the previous checkpoint or the new one whole; readers ignore staging
  directories and the manager sweeps them;
- **integrity manifest**: the sha256 of each file's raw bytes, checked on
  load: a flipped bit or a truncated file raises
  :class:`CheckpointCorruptError`;
- **hostile names**: entry names are percent-escaped into flat file names;
- **bfloat16 without ml_dtypes**: a bfloat16 tensor is stored as its
  ``uint16`` view with ``dtype: "bfloat16"`` and ``stored_as: "uint16"``
  recorded, exactly as the reference stores an ``ml_dtypes`` array, and
  is read back through a torch view. ``load_sharded`` returns CPU torch
  tensors.

With ``PADDLE_CKPT_TEST_SLEEP_S`` set (fault-injection drills only) the
writer prints ``CKPT_WRITE <file>`` and ``CKPT_COMMIT <path>`` marker lines
and sleeps at each, the windows ``tools/faultinject.py`` kills in.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np
import torch

__all__ = [
    "save_sharded", "load_sharded", "AsyncCheckpointHandle",
    "CheckpointCorruptError", "is_checkpoint_dir", "list_checkpoints",
    "load_checkpoint_extra", "checkpoint_nbytes", "prune_checkpoints",
    "quarantine_checkpoint", "sweep_stale_staging", "decode_entry_name",
]

FORMAT_VERSION = 2
META_NAME = "meta.json"
EXTRA_NAME = "extra.json"
_TMP_MARK = ".tmp-"
_CORRUPT_MARK = ".corrupt-"
# threads that hash and write (or read and verify) entries at once
_IO_THREADS = 4

# dtypes numpy cannot hold, by the name the reference records (ml_dtypes'
# names): stored as the unsigned integer view of the same width
_VIEW_DTYPES = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
                "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8,
                                  np.uint8),
                "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}
_VIEW_OF_TORCH = {v[0]: k for k, v in _VIEW_DTYPES.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory is missing, truncated, or fails its
    integrity manifest: recoverable by falling back to an older one."""


# ------------------------------------------------------------- metrics
def _metrics():
    """(save_ms, restore_ms, bytes_gauge) on the default registry,
    resolved at each use so a test that resets the registry sees live
    families."""
    from ..observability.registry import default_registry
    reg = default_registry()
    return (
        reg.histogram("paddle_ckpt_save_ms",
                      "checkpoint save duration, snapshot to commit",
                      ("mode",)),
        reg.histogram("paddle_ckpt_restore_ms",
                      "checkpoint load duration, read to placement"),
        reg.gauge("paddle_ckpt_bytes",
                  "total bytes of the last committed checkpoint"),
    )


# ---------------------------------------------------------- test hooks
def _test_hook(stage: str, path: str):
    """Fault-injection point: with PADDLE_CKPT_TEST_SLEEP_S set, print a
    marker and sleep, so a killer can land a SIGKILL inside that save
    phase. Inert otherwise."""
    s = os.environ.get("PADDLE_CKPT_TEST_SLEEP_S")
    if not s:
        return
    # one write: the marker must not interleave with the training loop's
    # own lines
    sys.stdout.write(f"CKPT_{stage} {path}\n")
    sys.stdout.flush()
    time.sleep(float(s))


# ------------------------------------------------------ name / dtype io
def _fname_for(name: str) -> str:
    """Flat, filesystem-safe file name for an entry name: every byte but
    letters and digits is percent-escaped, so ``../x`` cannot leave the
    directory."""
    return quote(name, safe="") + ".npy"


def _check_fname(fname: str) -> str:
    """Reject manifest file names that could leave the directory."""
    if (not fname or fname != os.path.basename(fname)
            or os.path.isabs(fname) or "/" in fname or "\\" in fname
            or fname in (".", "..")):
        raise CheckpointCorruptError(
            f"unsafe entry filename {fname!r} in checkpoint manifest")
    return fname


def _dtype_is_npy_native(dt: np.dtype) -> bool:
    """True when np.save/np.load round-trip this dtype exactly (an
    ``ml_dtypes`` dtype would come back as raw void records)."""
    try:
        descr = np.lib.format.dtype_to_descr(dt)
        return np.lib.format.descr_to_dtype(descr) == dt and dt.kind != "V"
    except Exception:  # noqa: BLE001 - any descr failure: not native
        return False


def _write_json(path: str, obj, fsync: bool = True):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


# ----------------------------------------------------------- the handle
class AsyncCheckpointHandle:
    """Owns the writer thread of one async save, started once in
    ``__init__``. ``done()`` reports whether the write finished (an event
    the writer sets in a ``finally``)."""

    def __init__(self, target: Callable[[], object]):
        self.exception: Optional[BaseException] = None
        self.result = None
        self._finished = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: List[Callable] = []

        def _run():
            try:
                self.result = target()
            except BaseException as e:  # surfaced on wait()
                self.exception = e
            finally:
                self._finished.set()
                with self._cb_lock:
                    cbs, self._callbacks = self._callbacks, []
                for cb in cbs:
                    try:
                        cb(self)
                    except Exception:  # noqa: BLE001 - a broken observer
                        pass           # must not mask the save result

        self._thread = threading.Thread(
            target=_run, daemon=True, name="paddle-ckpt-writer")
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the writer (bounded when ``timeout`` is given). Returns
        ``done()``; re-raises the writer's exception once finished."""
        self._thread.join(timeout)
        if self._finished.is_set() and self.exception is not None:
            raise self.exception
        return self._finished.is_set()

    def done(self) -> bool:
        return self._finished.is_set()

    def add_done_callback(self, fn: Callable):
        """Run ``fn(handle)`` on the writer thread after the save finishes
        (at once, on the caller, if it already has)."""
        with self._cb_lock:
            if not self._finished.is_set():
                self._callbacks.append(fn)
                return
        fn(self)


# ---------------------------------------------------- host snapshot
_ALIGN = 256      # bytes: each entry's offset in a snapshot buffer


class _PinnedBuffer:
    """A page-locked host buffer for the snapshots of CUDA tensors, kept
    by its owner between saves (``CheckpointManager`` holds one and frees
    it in ``close()``): exactly the bytes asked for, a plain allocation
    registered with ``cudaHostRegister`` (PyTorch's pinned-block cache
    would round every tensor up to a power of two). The owner starts no
    save into it while an earlier save still writes from it."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def get(self, nbytes: int) -> torch.Tensor:
        """The buffer, page-locked anew when it holds fewer bytes."""
        if self._buf is None or self._buf.numel() < nbytes:
            self.free()
            buf = torch.empty(nbytes, dtype=torch.uint8)
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                buf.data_ptr(), nbytes, 0))
            self._buf = buf
        return self._buf

    def free(self):
        if self._buf is not None:
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostUnregister(self._buf.data_ptr()))
            self._buf = None


def _torch_of(v):
    """The torch tensor behind a Paddle tensor or parameter (a placed
    tensor gathered), or None."""
    if hasattr(v, "full") and hasattr(v, "spec") and hasattr(v, "shards"):
        return v.full()
    data = getattr(v, "_data", None)
    if isinstance(data, torch.Tensor):
        return data
    return v if isinstance(v, torch.Tensor) else None


def _spec_of(v):
    """The entry's recorded spec: a placed tensor's, or a ``dist_spec``
    attribute (the reference's ``_spec_of``), as a list; else None."""
    spec = getattr(v, "spec", None) if hasattr(v, "shards") else \
        getattr(v, "dist_spec", None)
    if spec is None:
        return None
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def _as_numpy(host: torch.Tensor):
    """(numpy array, recorded dtype name, stored_as or None) of a CPU
    tensor, sharing its memory."""
    name = _VIEW_OF_TORCH.get(host.dtype)
    if name is not None:
        _, int_t, np_u = _VIEW_DTYPES[name]
        arr = host.view(int_t).numpy().view(np_u)
        return arr, name, str(np.dtype(np_u))
    arr = host.numpy()
    return arr, str(arr.dtype), None


def _snapshot(state_dict: Dict[str, object],
              host_buffer: Optional[_PinnedBuffer] = None):
    """Copy every value to private host memory now and build the manifest
    entries (without digests: the writer adds them). CUDA tensors go into
    ``host_buffer``, or into a pageable buffer of this call's own. Returns
    (entries, [(name, array)])."""
    values = []
    specs = {}
    for name, v in state_dict.items():
        if not isinstance(name, str) or not name:
            raise ValueError(f"checkpoint entry names must be non-empty "
                             f"strings, got {name!r}")
        specs[name] = _spec_of(v)
        t = _torch_of(v)
        values.append((name, v if t is None else t.detach()))
    offsets, nbytes = {}, 0
    for name, v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            offsets[name] = nbytes
            nbytes += -(-v.numel() * v.element_size() // _ALIGN) * _ALIGN
    arena = host_buffer.get(nbytes) if host_buffer is not None and \
        nbytes else torch.empty(nbytes, dtype=torch.uint8)
    streams: Dict[torch.device, torch.cuda.Stream] = {}
    entries: Dict[str, dict] = {}
    hosts: List = []
    try:
        for name, v in values:
            if isinstance(v, torch.Tensor):
                if v.is_cuda:
                    s = streams.get(v.device)
                    if s is None:
                        s = streams[v.device] = torch.cuda.Stream(v.device)
                        # after every update already queued on the
                        # caller's stream, never on it
                        s.wait_stream(torch.cuda.current_stream(v.device))
                    off = offsets[name]
                    host = arena[off:off + v.numel() * v.element_size()] \
                        .view(v.dtype).view(v.shape)
                    with torch.cuda.stream(s):
                        host.copy_(v, non_blocking=True)
                else:
                    host = torch.empty(v.shape, dtype=v.dtype)
                    host.copy_(v)
                arr, dtype_name, stored_as = _as_numpy(host)
            else:
                arr = np.array(np.asarray(v), copy=True, order="C")
                dt = np.dtype(arr.dtype)
                dtype_name, stored_as = str(dt), None
                if not _dtype_is_npy_native(dt):
                    stored = np.dtype(f"u{dt.itemsize}")
                    arr = arr.view(stored)
                    stored_as = str(stored)
            ent = {"shape": [int(d) for d in arr.shape],
                   "dtype": dtype_name, "spec": specs[name],
                   "file": _fname_for(name)}
            if stored_as is not None:
                ent["stored_as"] = stored_as
            entries[name] = ent
            hosts.append((name, arr))
    finally:
        # no copy into the buffer outlives the call, even a failed one
        for s in streams.values():
            s.synchronize()
    return entries, hosts


# --------------------------------------------------------------- save
def _write_entry(tmp_dir: str, ent: dict, host: np.ndarray,
                 fsync: bool) -> int:
    ent["sha256"] = _sha256(host)
    fpath = os.path.join(tmp_dir, ent["file"])
    _test_hook("WRITE", fpath)
    with open(fpath, "wb") as f:
        np.save(f, host, allow_pickle=False)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return os.path.getsize(fpath)


def _write_and_commit(tmp_dir: str, path: str, entries, hosts, extra,
                      fsync: bool = True) -> int:
    """Hash and write every file into the staging directory (fsync each),
    the manifest last, then rename the directory into place. Returns the
    bytes committed."""
    total = 0
    try:
        with ThreadPoolExecutor(_IO_THREADS) as ex:
            total += sum(ex.map(
                lambda nh: _write_entry(tmp_dir, entries[nh[0]], nh[1],
                                        fsync), hosts))
        if extra is not None:
            epath = os.path.join(tmp_dir, EXTRA_NAME)
            _write_json(epath, extra, fsync)
            total += os.path.getsize(epath)
        mpath = os.path.join(tmp_dir, META_NAME)
        _write_json(mpath, {"format": FORMAT_VERSION, "entries": entries},
                    fsync)
        total += os.path.getsize(mpath)
        if fsync:
            _fsync_dir(tmp_dir)
        _test_hook("COMMIT", path)
        if os.path.isdir(path):
            # overwrite in place: swap through a sidecar so the path never
            # holds a partial directory
            old = path + f".old-{uuid.uuid4().hex[:8]}"
            os.replace(path, old)
            os.replace(tmp_dir, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp_dir, path)
        if fsync:
            _fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return total


def save_sharded(state_dict: Dict[str, object], path: str,
                 async_save: bool = False, extra: Optional[dict] = None,
                 fsync: bool = True, *,
                 host_buffer: Optional[_PinnedBuffer] = None):
    """Write a checkpoint directory atomically from torch tensors (any
    device), Paddle tensors or numpy arrays.

    Every value is copied to host memory before this returns (updating the
    source tensors afterwards cannot reach the checkpoint). With
    ``async_save`` the hashing, the writes and the commit run on a
    background thread and an :class:`AsyncCheckpointHandle` is returned
    (``.wait()`` surfaces errors and blocks on durability). ``extra`` is
    a JSON-serialisable sidecar readable through
    :func:`load_checkpoint_extra`. CUDA tensors are copied into
    ``host_buffer`` when one is given (its owner starts no other save into
    it until this one's write ends), else into pageable memory of this
    call's own."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    entries, hosts = _snapshot(state_dict, host_buffer)
    tmp_dir = path + _TMP_MARK + uuid.uuid4().hex[:8]
    os.makedirs(tmp_dir)
    mode = "async" if async_save else "sync"

    def write():
        try:
            total = _write_and_commit(tmp_dir, path, entries, hosts, extra,
                                      fsync=fsync)
        finally:
            hosts.clear()
        try:
            save_ms, _, bytes_gauge = _metrics()
            save_ms.labels(mode).observe((time.perf_counter() - t0) * 1e3)
            bytes_gauge.set(total)
        except Exception:  # noqa: BLE001 - telemetry must never fail
            pass           # the save it measures
        return total

    if async_save:
        return AsyncCheckpointHandle(write)
    write()
    return None


# --------------------------------------------------------------- load
def _read_meta(path: str) -> Dict[str, dict]:
    mpath = os.path.join(path, META_NAME)
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{path}: no {META_NAME} (uncommitted or not a checkpoint "
            f"directory)") from e
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: "
                                     f"{e}") from e
    if not isinstance(meta, dict):
        raise CheckpointCorruptError(f"{path}: malformed manifest")
    entries = meta["entries"] if "entries" in meta else meta  # format 1
    if not isinstance(entries, dict):
        raise CheckpointCorruptError(f"{path}: malformed manifest entries")
    return entries


def _load_entry(path: str, name: str, ent, verify: bool) -> torch.Tensor:
    if not isinstance(ent, dict):
        raise CheckpointCorruptError(f"{path}: malformed entry {name!r}")
    fname = _check_fname(ent.get("file") or f"{name}.npy")
    fpath = os.path.join(path, fname)
    try:
        raw = np.load(fpath, allow_pickle=False)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{path}: missing array file {fname!r} for {name!r}") from e
    except Exception as e:  # noqa: BLE001 - truncated/garbled .npy
        raise CheckpointCorruptError(
            f"{path}: unreadable array file {fname!r} for {name!r}: "
            f"{e}") from e
    if verify and "sha256" in ent:
        digest = _sha256(raw)
        if digest != ent["sha256"]:
            raise CheckpointCorruptError(
                f"{path}: checksum mismatch for {name!r} "
                f"(stored {ent['sha256'][:12]}…, got {digest[:12]}…)")
    if "shape" in ent and tuple(raw.shape) != tuple(ent["shape"]):
        raise CheckpointCorruptError(
            f"{path}: shape mismatch for {name!r}: manifest says "
            f"{tuple(ent['shape'])}, file holds {tuple(raw.shape)}")
    if not raw.flags["C_CONTIGUOUS"]:   # a Fortran-ordered file
        raw = raw.copy(order="C")
    if ent.get("stored_as"):
        view = _VIEW_DTYPES.get(ent.get("dtype"))
        if view is None or raw.dtype.itemsize != \
                np.dtype(view[2]).itemsize:
            raise CheckpointCorruptError(
                f"{path}: cannot restore dtype {ent.get('dtype')!r} for "
                f"{name!r}")
        return torch.from_numpy(raw.view(view[2]).view(
            {1: np.int8, 2: np.int16}[raw.dtype.itemsize])).view(view[0])
    return torch.from_numpy(raw)


def load_sharded(path: str, mesh=None, verify: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """Read a checkpoint directory (this package's or the reference's),
    verifying each entry's sha256 when ``verify``. With ``mesh`` (default:
    the global mesh) an entry with a recorded spec is placed by it (a
    ``MeshTensor``, axes the mesh lacks replicated, as the reference's);
    every other entry is a CPU tensor, carrying its recorded spec as
    ``dist_spec``. Raises :class:`CheckpointCorruptError` on a missing,
    truncated or corrupt directory."""
    if mesh is None:
        from ..distributed.mesh_utils import get_global_mesh
        mesh = get_global_mesh()
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    entries = _read_meta(path)
    items = list(entries.items())
    with ThreadPoolExecutor(_IO_THREADS) as ex:
        tensors = list(ex.map(
            lambda kv: _load_entry(path, kv[0], kv[1], verify), items))
    out = {}
    for (name, ent), t in zip(items, tensors):
        spec = ent.get("spec")
        if spec is not None:
            spec = tuple(tuple(a) if isinstance(a, list) else a
                         for a in spec)
            if mesh is not None:
                from ..distributed.mesh_utils import MeshTensor
                t = MeshTensor.place(t, mesh, spec)
            else:
                t.dist_spec = spec
        out[name] = t
    try:
        _, restore_ms, _ = _metrics()
        restore_ms.observe((time.perf_counter() - t0) * 1e3)
    except Exception:  # noqa: BLE001
        pass
    return out


def load_checkpoint_extra(path: str) -> Optional[dict]:
    """The ``extra`` sidecar of ``save_sharded(extra=...)``, or None."""
    epath = os.path.join(path, EXTRA_NAME)
    try:
        with open(epath) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable {EXTRA_NAME}: "
                                     f"{e}") from e


# --------------------------------------------------- directory hygiene
def is_checkpoint_dir(path: str) -> bool:
    """A committed checkpoint: a directory holding a manifest, and not a
    staging (``.tmp-``) or quarantined (``.corrupt-``) leftover."""
    base = os.path.basename(os.path.normpath(path))
    if _TMP_MARK in base or _CORRUPT_MARK in base:
        return False
    return os.path.isfile(os.path.join(path, META_NAME))


def list_checkpoints(root: str) -> List[str]:
    """Committed checkpoint directories under ``root``, oldest first by
    mtime (name as tiebreak)."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    found = []
    for n in sorted(names):
        p = os.path.join(root, n)
        if is_checkpoint_dir(p):
            try:
                found.append((os.path.getmtime(p), p))
            except OSError:
                continue  # racing deletion
    found.sort(key=lambda t: (t[0], t[1]))
    return [p for _, p in found]


def checkpoint_nbytes(path: str) -> int:
    total = 0
    try:
        for n in os.listdir(path):
            try:
                total += os.path.getsize(os.path.join(path, n))
            except OSError:
                pass
    except OSError:
        pass
    return total


def quarantine_checkpoint(path: str) -> Optional[str]:
    """Move a corrupt or partial checkpoint aside (never delete: the
    operator may want it). Returns the new path."""
    dst = path.rstrip("/\\") + _CORRUPT_MARK + uuid.uuid4().hex[:8]
    try:
        os.replace(path, dst)
        return dst
    except OSError:
        return None


def prune_checkpoints(root: str, keep: int) -> List[str]:
    """Delete the oldest committed checkpoints under ``root`` beyond the
    newest ``keep`` (``keep <= 0`` keeps all). Returns the deleted
    paths."""
    if keep <= 0:
        return []
    ckpts = list_checkpoints(root)
    dead = ckpts[:-keep] if len(ckpts) > keep else []
    removed = []
    for p in dead:
        shutil.rmtree(p, ignore_errors=True)
        if not os.path.exists(p):
            removed.append(p)
    return removed


def sweep_stale_staging(root: str, min_age_s: float = 0.0) -> List[str]:
    """Remove leftover ``.tmp-`` staging directories under ``root``, the
    debris of writers killed mid-save. The caller must own the directory
    (one writer per directory); ``min_age_s`` spares fresh stages."""
    removed = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return removed
    now = time.time()
    for n in names:
        if _TMP_MARK not in n:
            continue
        p = os.path.join(root, n)
        if not os.path.isdir(p):
            continue
        try:
            if min_age_s and now - os.path.getmtime(p) < min_age_s:
                continue
        except OSError:
            continue
        shutil.rmtree(p, ignore_errors=True)
        if not os.path.exists(p):
            removed.append(p)
    return removed


def decode_entry_name(fname: str) -> str:
    """Inverse of the manifest file-name escaping."""
    return unquote(fname[:-4] if fname.endswith(".npy") else fname)
