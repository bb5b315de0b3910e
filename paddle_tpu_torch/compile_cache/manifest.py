"""Warmup manifest: the batch signatures a server's traffic dispatched
(the port of ``paddle_tpu/compile_cache/manifest.py``, the same JSON: each
package reads the other's file).

``InferenceServer.warmup()`` can run the full bucket lattice, but
production traffic usually exercises a small subset of it. The manifest
persists exactly the signatures traffic dispatched (feed shapes + dtypes
of each padded device batch), so a restarted server replays the
*observed* lattice before traffic: on the card each replay pays a
signature's first-dispatch costs (the cached first-dispatch record's
load, cuBLAS's heuristics, the caching allocator's growth, the kernels'
lazy module loads) instead of the first user's request.

The file is JSON (human-inspectable), written atomically on every new
signature (new signatures are rare — one per bucket, ever), and a
corrupt or version-skewed manifest simply starts empty: it is an
optimization artifact, never a source of truth.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["WarmupManifest"]

MANIFEST_VERSION = 1


class WarmupManifest:
    """Persisted set of dispatched batch signatures for one (server,
    model) pair. Entries are ``{"feeds": [[shape, dtype], ...],
    "site": str}`` — the exact padded host-batch layout handed to the
    predictor (site "predict", the default) or to the decode engine's
    dispatch ("generate_prefill", "generate_chunked", "generate_decode",
    "generate_verify"),
    so a replayer only re-executes the signatures of ITS dispatch
    path. Pre-site manifests load with site "predict"."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._load()

    @staticmethod
    def default_path(cache_dir: str, server_name: str,
                     model_fingerprint: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in server_name)
        return os.path.join(cache_dir, "warmup",
                            f"{safe}-{model_fingerprint[:16]}.json")

    def _load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("version") != MANIFEST_VERSION:
                return
            for entry in data.get("entries", []):
                feeds = [(tuple(int(d) for d in shape), str(dtype))
                         for shape, dtype in entry["feeds"]]
                site = str(entry.get("site", "predict"))
                self._entries[self._key(feeds, site)] = {
                    "feeds": feeds, "site": site}
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001 - corrupt manifest: start empty
            self._entries = {}

    @staticmethod
    def _key(feeds: Sequence[Tuple[tuple, str]],
             site: str = "predict") -> str:
        return json.dumps([site, [[list(s), d] for s, d in feeds]])

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def specs(self, site: Optional[str] = None) -> List[dict]:
        """Recorded signatures, each ``{"feeds": [(shape, dtype), ...],
        "site": str}`` — the replay input for ``warmup_from_manifest``.
        ``site`` filters to one dispatch path (None = all)."""
        with self._lock:
            return [dict(e) for e in self._entries.values()
                    if site is None or e["site"] == site]

    def record(self, feeds: Sequence[Tuple[tuple, str]],
               site: str = "predict") -> bool:
        """Add one signature (``[(shape, dtype), ...]`` of the padded
        batch) and write through if new; returns True when it was new.
        Never raises — an unwritable manifest costs only warmup breadth
        on the next restart."""
        feeds = [(tuple(int(d) for d in shape), str(dtype))
                 for shape, dtype in feeds]
        key = self._key(feeds, site)
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = {"feeds": feeds, "site": str(site)}
            entries = [dict(e) for e in self._entries.values()]
        try:
            self._write(entries)
        except Exception:  # noqa: BLE001 - see docstring
            pass
        return True

    def _write(self, entries: List[dict]):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        data = {"version": MANIFEST_VERSION,
                "entries": [{"feeds": [[list(s), d]
                                       for s, d in e["feeds"]],
                             "site": e.get("site", "predict")}
                            for e in entries]}
        fd, tmp = tempfile.mkstemp(
            prefix=".tmp-", suffix=".json",
            dir=os.path.dirname(self.path) or ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
