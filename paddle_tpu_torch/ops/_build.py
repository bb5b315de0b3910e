"""Build and load the port's CUDA kernels.

The sources under ``paddle_tpu_torch/csrc`` have a plain C interface, so
they are compiled with ``nvcc`` straight into one shared library and bound
with ``ctypes`` (no PyTorch headers, so the build takes seconds, not
minutes). The library lands in ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once. Each
source compiles in its own ``nvcc`` process, all started together, and one
final ``nvcc`` links the objects.

Nothing here runs at import time: a CPU-only install imports every module of
the package and never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_seconds", "build_log", "check",
           "DTYPE_CODES"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_fwd.cu", "paged_attention.cu")
HEADERS = ("common.cuh",)
# -Xptxas=-v: registers, shared memory and spills per kernel, kept in
# build_log() for whoever needs to read them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# element type codes shared with csrc/common.cuh (pt::DType)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_LOCK = threading.Lock()
_LIB = None
_BUILD_SECONDS = 0.0
_BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, lse, B, H, Sq, Sk, D, q strides (b, s, h), k strides,
    # v strides, scale, causal, dtype, stream
    "pt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                     _F, _I, _I, _P],
    # q, k_pool, v_pool, out, tables, ctx, valid, positions, B, S, H, D,
    # num_pages, page_size, P, q strides (b, s, h), scale, kind, dtype,
    # stream
    "pt_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I64, _I64, _I64, _F, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from paddle_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    return proc.stdout


def _build(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        errors, log = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                errors.append(log[-1])
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / target.name
        _run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)])
        os.replace(tmp_so, target)   # atomic: a concurrent loader sees
        #                              either no library or a whole one
    return "\n".join(log)


def load_library():
    """Build (once per source hash) and load the kernel library; returns
    the ``ctypes.CDLL`` with every entry point's ``argtypes`` set."""
    global _LIB, _BUILD_SECONDS, _BUILD_LOG
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            target = BUILD_DIR / f"libpaddle_tpu_torch_{_digest()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _BUILD_LOG = _build(target)
                _BUILD_SECONDS = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def build_seconds() -> float:
    """Seconds this process spent compiling (0 when the library was
    already built)."""
    return _BUILD_SECONDS


def build_log() -> str:
    """nvcc's output (with ptxas' per-kernel resource lines) from this
    process's build; empty when the library was already built."""
    return _BUILD_LOG


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        what = _LIB.pt_error_string(err).decode() if _LIB else ""
        raise RuntimeError(f"{name}: CUDA error {err} ({what}) at launch")
