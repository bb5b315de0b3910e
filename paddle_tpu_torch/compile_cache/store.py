"""Disk store for compile-cache entries (the port of
``paddle_tpu/compile_cache/store.py``: the same guarantees and on-disk
layout, so either package reads the other's directory of records).

One entry = one file ``<key>.pdcc`` holding a pickled record
``{"version", "kind", "payload", "meta"}``. Properties the serving and
training cold paths depend on:

- **atomic writes**: a record is written to a unique temp file in the
  cache directory and ``os.replace``d into place, so a reader (or a
  concurrent writer racing on the same key) can never observe a
  half-written entry — it sees the old file, the new file, or no file;
- **corruption tolerance**: any failure to read/unpickle/validate an
  entry evicts that file and reports a miss — a flipped bit in the
  cache can cost a fresh measurement, never a crash;
- **size-bounded LRU**: after every write the store evicts
  least-recently-used entries (mtime order; reads touch mtime) until
  total size fits ``max_bytes``. The just-written entry is never
  evicted by its own write, even if oversized — the caller paid for the
  measurement and gets to use it at least once.

TRUST: records are unpickled on read (the port's payloads are
first-dispatch records, dicts of numbers, but the reference's are pickled
executables and the format is one), so anyone who can write to the
cache directory can execute code in every process that reads it. The
store creates the directory private-by-default (0o700) and the
directory must only ever be one the deploying user trusts — never a
shared or group-writable path (see ``FLAGS_compile_cache_dir``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["CacheStore", "RECORD_VERSION"]

RECORD_VERSION = 1
_SUFFIX = ".pdcc"


class CacheStore:
    """Filesystem-backed key -> record map with the guarantees above.

    Thread-safe within a process; cross-process safety comes from the
    atomic-rename write protocol (multiple writers on the same key:
    last replace wins, both records were complete and equivalent)."""

    def __init__(self, directory: str, max_bytes: int = 0):
        self.directory = os.path.abspath(directory)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # private-by-default: entries are unpickled on read, so the
        # directory is a code-execution surface (module docstring); a
        # pre-existing directory's mode is the operator's choice and is
        # never widened or narrowed here
        os.makedirs(self.directory, mode=0o700, exist_ok=True)

    def path_for(self, key: str) -> str:
        return os.path.join(self.directory, key + _SUFFIX)

    # ------------------------------------------------------------ read
    def get(self, key: str) -> Optional[Dict]:
        """The record for ``key``, or None when absent. A corrupt entry
        is deleted and the original error re-raised so the caller can
        count it separately from a plain miss. Touches mtime so the LRU
        order tracks use, not just creation."""
        path = self.path_for(key)
        try:
            with open(path, "rb") as f:
                record = pickle.load(f)
            if not isinstance(record, dict) or \
                    record.get("version") != RECORD_VERSION or \
                    "kind" not in record or "payload" not in record:
                raise ValueError(f"malformed cache record for {key}")
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 - corrupt entry: evict, miss
            self.remove(key)
            raise
        try:
            os.utime(path)
        except OSError:
            pass  # concurrently evicted: the loaded record is still good
        return record

    # ----------------------------------------------------------- write
    def put(self, key: str, record: Dict) -> int:
        """Atomically write ``record``; returns bytes written. Runs LRU
        eviction afterwards (never evicting ``key`` itself)."""
        record = dict(record, version=RECORD_VERSION)
        data = pickle.dumps(record, protocol=4)
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=_SUFFIX,
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self.path_for(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.evict_to_fit(keep=key)
        return len(data)

    def remove(self, key: str) -> bool:
        try:
            os.unlink(self.path_for(key))
            return True
        except OSError:
            return False

    # ------------------------------------------------------- inventory
    def entries(self) -> List[Tuple[str, int, float]]:
        """(key, size_bytes, mtime) for every entry, oldest first.
        Temp files from in-flight writers are excluded."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if not name.endswith(_SUFFIX) or name.startswith(".tmp-"):
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # raced with an eviction
            out.append((name[:-len(_SUFFIX)], st.st_size, st.st_mtime))
        out.sort(key=lambda e: e[2])
        return out

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self.entries())

    def evict_to_fit(self, keep: Optional[str] = None) -> int:
        """Evict LRU entries until total size <= max_bytes (0 = no
        bound). Returns the number of entries evicted."""
        if self.max_bytes <= 0:
            return 0
        with self._lock:
            entries = self.entries()
            total = sum(size for _, size, _ in entries)
            evicted = 0
            for key, size, _ in entries:
                if total <= self.max_bytes:
                    break
                if key == keep:
                    continue
                if self.remove(key):
                    total -= size
                    evicted += 1
            return evicted
