"""paddle_tpu_torch.compile_cache — the persistent compile cache and
warmup manifests (the port of ``paddle_tpu/compile_cache``).

Cold start is what a fresh process pays before its first useful answer.
The reference keeps compiled XLA executables across processes; the port
compiles no program at run time, so it keeps what does outlive a process
(``cache.py`` says why):

- ``fingerprint``: stable cache keys over (function/model identity,
  operand signature, compile-relevant ``FLAGS_*``, torch/CUDA/card/kernel
  library identity) — computed without running the model;
- ``store``: a disk store with atomic writes, size-bounded LRU eviction,
  and corruption-tolerant reads (a bad entry is evicted, never fatal);
- ``cache``: ``CompileCache`` — each signature's first-dispatch record
  (FLOPs, bytes, memory), so a hit skips xstats' measurement, plus the
  ``paddle_compile_cache_*`` metric families;
- ``manifest``: ``WarmupManifest`` — the batch signatures a serving
  process's traffic dispatched, so a restart replays exactly the observed
  lattice before traffic.

Wired into the port's three dispatch sites — ``jit.TrainStep``, the
serving ``Predictor`` and the decoder's ``CachedDecoder`` — and into the
warmups of ``InferenceServer``, ``GenerationServer`` and the fleet worker
(``--warmup manifest``). ``jit.to_static``'s site waits for ``to_static``
(ROADMAP queue 1 item 5d). Enable with ``FLAGS_compile_cache_dir=/path``
(and optionally ``FLAGS_compile_cache_max_bytes``); measure with
``python -m paddle_tpu_torch.tools.bench_coldstart``.
"""
from __future__ import annotations

from . import fingerprint  # noqa: F401
from .cache import (  # noqa: F401
    CompileCache, default_cache, reset_default_cache, stats,
)
from .fingerprint import (  # noqa: F401
    avals_signature, bytes_fingerprint, cache_key, compile_relevant_flags,
    environment_fingerprint, function_fingerprint, layer_fingerprint,
    mark_compile_relevant, mesh_fingerprint,
)
from .manifest import WarmupManifest  # noqa: F401
from .store import CacheStore  # noqa: F401

__all__ = [
    "CompileCache", "CacheStore", "WarmupManifest",
    "default_cache", "reset_default_cache", "stats",
    "cache_key", "function_fingerprint", "layer_fingerprint",
    "mesh_fingerprint", "environment_fingerprint", "avals_signature",
    "bytes_fingerprint", "compile_relevant_flags", "mark_compile_relevant",
    "fingerprint",
]
