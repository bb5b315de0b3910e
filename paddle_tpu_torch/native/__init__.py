"""The port's host-side native code, built at first use and bound with
``ctypes`` (the counterpart of ``paddle_tpu/native/__init__.py``).

Today one source: ``csrc/host/shm_ring.cc``, the DataLoader's shared-memory
batch transport (``native/shm_ring.py``). It is compiled with the host C++
compiler (``$CXX``, else ``g++``) into ``paddle_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the source and flags, so
an unchanged source loads at once. A build that fails raises: nothing falls
back to another transport because the library is missing. Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["host_library"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "host" / "shm_ring.cc",)
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
# name -> (argtypes, restype)
_SIGNATURES = {
    "shm_ring_open": ([ctypes.c_char_p, ctypes.c_int, _U64, _U64], _P),
    "shm_ring_push": ([_P, ctypes.c_char_p, _U64], ctypes.c_int),
    "shm_ring_pop": ([_P, ctypes.c_char_p, _U64, ctypes.c_int],
                     ctypes.c_longlong),
    "shm_ring_size": ([_P], _U64),
    "shm_ring_close": ([_P], None),
    "shm_ring_free": ([_P], None),
}

_LOCK = threading.Lock()
_LIB = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler found ($CXX, g++, c++): the "
                       "DataLoader's shared-memory ring is built from "
                       "paddle_tpu_torch/csrc/host at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / target.name
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp_so),
               *map(str, SOURCES), "-lrt"]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host library build failed: {' '.join(cmd)}"
                               f"\n{proc.stdout}")
        os.replace(tmp_so, target)   # atomic for a concurrent loader


def host_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the host library, every entry
    point's ``argtypes`` and ``restype`` set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            target = BUILD_DIR / f"libpaddle_tpu_torch_host_{_digest()}.so"
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
    return _LIB
