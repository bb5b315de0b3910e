"""GenerationServer: continuous-batching autoregressive decode serving (the
port of ``paddle_tpu/serving/generation/engine.py``).

Orca-style iteration-level scheduling (Yu et al., OSDI '22) over the paged
KV cache: the in-flight decode batch is re-formed EVERY step — new sequences
join as soon as a slot and pages free up, finished ones are evicted the step
they finish. There is one decode shape, ``[max_batch, 1]``, with dead lanes
slot-masked.

Flow per worker iteration:

1. **admit**: pop FIFO requests while a batch slot AND their full page
   reservation are available; drop expired ones (``DeadlineExceededError``:
   a scheduling deadline gates admission, never an in-flight stream).
   Admission consults the shared-prefix radix index (prefix_cache.py)
   first: matched full pages are mapped into the block table (refcounted
   sharing), shrinking the reservation AND the prefill window; under pool
   pressure cache-only pages are LRU-evicted and the reservation retried.
2. **prefill**: cold prompts run one forward per (pow2 rows, sequence
   bucket) group, writing the prompt K/V into their pages; prefix hits run
   the CHUNKED suffix prefill instead (attention reaches the cached prefix
   through the block tables). The first token is sampled from the last
   position, and every prompt's full pages are published to the index.
3. **decode**: one fixed-shape step for every live lane; sampling on the
   host (vectorized, per-request RNG); tokens stream out through each
   request's ``StreamingFuture``. With a draft model, each iteration is
   instead draft-propose-k plus ONE ``[max_batch, k+1]`` verify step with
   accept-and-resample (speculative decoding; the output distribution is
   unchanged).
4. **evict**: eos / length / cancelled / hard-deadline sequences release
   their pages at once; completed sequences' full pages stay behind in the
   prefix index (refcount 1) until pool pressure LRU-evicts them.

Backpressure: a bounded queue raising ``QueueFullError``,
``ServerClosedError`` after shutdown, and a fault barrier that fails only
the affected requests, never the worker.

The operations plane: ``DecodeMetrics`` records into the process-wide
registry under the reference's ``paddle_decode_*`` families (and keeps the
windows ``metrics_snapshot()`` reads); a traced request (``tracing.
request_context()`` at submit) records ``queue``, ``prefill``,
``decode_step`` or ``verify``, ``shed`` and ``request`` spans; every
prefill group, decode iteration and verify window drops a ``stepprof``
envelope; ``telemetry_port=`` (or ``FLAGS_serving_telemetry_port``)
attaches the telemetry endpoint with ``decode:<name>`` health and
readiness checks, and ``engines_statusz()`` is the ``/statusz`` section.

Multi-tenant scheduling: with ``scheduler=`` (a
``scheduling.AdmissionController``) ``submit_generate(tenant=)`` debits the
tenant's token bucket by prompt + generation budget (the typed
``QuotaExceededError`` when it is spent), admission picks weighted-fair
across tenants (priority classes first), and a request that finds too few
free pages parks in-flight streams of a strictly lower priority class:
their pages go back, and each resumes later from its full token history on
the same future and RNG (a chunked prefill over its cached prompt pages),
or fails with ``QuotaExceededError`` when it cannot.

Readiness, for a fleet replica: with ``FLAGS_serving_ready_requires_warmup``
on, ``ready`` stays false until ``warmup()`` (the decode, verify, prefill
and chunked lattice, each signature run once on the device),
``warmup_from_manifest()`` or ``mark_ready()``; ``dispatch_signatures``
lists every signature the engine ran, as the reference's
``_note_dispatch`` records them.

Warmup manifests and the compile cache (reference ``:675-692,
1044-1090``): with ``FLAGS_compile_cache_dir`` set, the engine keeps a
``WarmupManifest`` (``decode-<name>`` and the decoder's ``fingerprint()``)
under the cache directory; the first TRAFFIC dispatch of each signature
(never a warmup's or a replay's) is written through to it, and
``warmup_from_manifest()`` replays the prefill, chunked, decode and verify
sites within ``max_batch`` and ``max_seq_len`` before traffic. The
snapshot's ``compile_cache`` section (``paddle_decode_compile_total``)
counts every target dispatch: without a cache the first run of a
signature in this engine is a miss and every later one a hit; with one, a
first run whose first-dispatch record the cache supplied is a hit too.

Not in this slice (ROADMAP): tensor-parallel meshes (item 5c).
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...framework.device import resolve_device, same_device
from ...framework.flags import flag_value
from ...observability import tracing
from ...observability.registry import default_registry
from ...observability.stepprof import default_profiler
from ...ops.paged_attention import kv_pool_bytes, resolve_kv_dtype
from ..bucketing import ShapeBucketPolicy
from ..request import (DeadlineExceededError, QueueFullError,
                       QuotaExceededError, ServerClosedError)
from .kv_cache import PagedKVCache
from .model_fns import CachedDecoder, supports_cached_decode
from .prefix_cache import PrefixCache
from .sampling import sample_next_tokens
from .spec_decode import _sample, accept_tokens, softmax

__all__ = ["GenerationServer", "StreamingFuture", "DecodeMetrics",
           "engines_statusz"]

# live-engine registry for /statusz (weak: a dropped engine vanishes)
_ENGINES_LOCK = threading.Lock()
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def engines_statusz() -> dict:
    """``/statusz`` section: every live engine's prefix-cache, speculative
    and page-accounting state (with the refcount-leak check) and, under a
    scheduler, its per-tenant queue depths."""
    with _ENGINES_LOCK:
        engines = list(_ENGINES)
    return {e.metrics.name: e.statusz() for e in engines}


class StreamingFuture:
    """A generation request's result handle: tokens land one by one as the
    engine emits them.

    Iterate (``for tok in fut``) to stream, or ``result(timeout)`` to block
    for the complete generated-token list; ``tokens()`` snapshots what has
    landed so far; ``cancel()`` asks the engine to evict the sequence at its
    next step. A failed request raises its exception from
    ``result()``/iteration.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._toks: List[int] = []
        self._exc: Optional[BaseException] = None
        self._done = False
        self._finish_reason: Optional[str] = None
        self._cancel_requested = False
        self._on_cancel = None

    # ---- consumer ----
    def __iter__(self):
        i = 0
        while True:
            with self._cond:
                while len(self._toks) <= i and not self._done:
                    self._cond.wait()
                if i < len(self._toks):
                    tok = self._toks[i]
                    i += 1
                else:
                    if self._exc is not None:
                        raise self._exc
                    return
            yield tok       # outside the lock: consumer code may block

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; returns ALL generated token ids
        (eos included when one was produced)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError("generation still streaming")
            if self._exc is not None:
                raise self._exc
            return list(self._toks)

    def tokens(self) -> List[int]:
        with self._cond:
            return list(self._toks)

    def done(self) -> bool:
        with self._cond:
            return self._done

    def exception(self) -> Optional[BaseException]:
        with self._cond:
            return self._exc

    @property
    def finish_reason(self) -> Optional[str]:
        """"eos" | "length" | "cancelled" | "error" | "timed_out" |
        "deadline" | "shutdown"; None while streaming."""
        with self._cond:
            return self._finish_reason

    def cancel(self) -> bool:
        """Request eviction; returns False when already finished. The
        engine honours it at its next harvest — tokens already emitted stay
        available. A registered cancel hook (the fleet router closes the
        stream's socket with it) fires outside the lock, so a routed
        stream's cancellation reaches the replica."""
        with self._cond:
            if self._done:
                return False
            self._cancel_requested = True
            hook = self._on_cancel
        if hook is not None:
            try:
                hook()
            except Exception:  # noqa: BLE001 - propagation is best
                pass           # effort; the local cancel already holds
        return True

    def _set_cancel_hook(self, hook):
        """Install or clear the propagation hook; when cancellation was
        already requested, fire it at once (the cancel raced the
        installation)."""
        with self._cond:
            self._on_cancel = hook
            fire = hook is not None and self._cancel_requested \
                and not self._done
        if fire:
            try:
                hook()
            except Exception:  # noqa: BLE001 - as above
                pass

    def cancelled(self) -> bool:
        with self._cond:
            return self._finish_reason == "cancelled"

    # ---- engine side ----
    def _emit(self, tok: int):
        with self._cond:
            self._toks.append(int(tok))
            self._cond.notify_all()

    def _finish(self, reason: str):
        with self._cond:
            if self._done:
                return
            self._done = True
            self._finish_reason = reason
            self._cond.notify_all()

    def _fail(self, exc: BaseException, reason: str = "error"):
        with self._cond:
            if self._done:
                return
            self._exc = exc
            self._done = True
            self._finish_reason = reason
            self._cond.notify_all()


class _Request:
    __slots__ = ("prompt", "max_new", "temperature", "rng", "future",
                 "submit_t", "deadline", "hard_deadline", "trace",
                 "t_wall_ns", "tenant", "prio_rank", "n_done", "cost")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 seed: Optional[int], timeout_ms: Optional[float],
                 trace=None, deadline_ms: Optional[float] = None,
                 tenant: str = "default", prio_rank: int = 1,
                 n_done: int = 0):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.rng = np.random.RandomState(seed)
        self.future = StreamingFuture()
        self.submit_t = time.monotonic()
        self.deadline = (self.submit_t + timeout_ms / 1e3
                         if timeout_ms else None)
        # the HARD end-to-end budget: an in-flight stream past it is
        # evicted at batch re-form, unlike the scheduling-only deadline
        self.hard_deadline = (self.submit_t + deadline_ms / 1e3
                              if deadline_ms else None)
        # trace identity (a tracing.TraceContext child whose span id is
        # the generate::request root span)
        self.trace = trace
        self.t_wall_ns = time.time_ns() if trace is not None else 0
        # multi-tenant scheduling: the WFQ cost is token-denominated
        # (prompt + generation budget); n_done counts tokens streamed
        # before a park/resume cycle, so TTFT and max_new accounting
        # survive preemption
        self.tenant = tenant
        self.prio_rank = int(prio_rank)
        self.n_done = int(n_done)
        self.cost = float(len(prompt) + self.max_new)

    def expired(self, now: float) -> bool:
        if self.deadline is not None and now > self.deadline:
            return True
        return self.hard_expired(now)

    def hard_expired(self, now: float) -> bool:
        return self.hard_deadline is not None and now > self.hard_deadline


class _ActiveSeq:
    """One live lane of the in-flight decode batch."""

    __slots__ = ("req", "slot", "pages", "ctx", "max_total", "last_token",
                 "n_generated", "last_emit_t", "prefix_len", "history",
                 "draft_ctx", "published")

    def __init__(self, req: _Request, slot: int, pages: List[int],
                 max_total: int, prefix_len: int = 0):
        self.req = req
        self.slot = slot
        self.pages = pages              # prefix pages first, private after
        self.ctx = len(req.prompt)      # tokens whose K/V is cached
        self.max_total = max_total      # prompt + generation budget
        self.last_token = -1
        self.n_generated = 0
        self.last_emit_t = 0.0
        self.prefix_len = int(prefix_len)   # cached tokens reused
        # full token history (prompt + emitted): the draft's catch-up and
        # publish-on-completion both key pages by content
        self.history: List[int] = [int(t) for t in req.prompt]
        self.draft_ctx = len(req.prompt)    # tokens cached in the draft pools
        self.published = False              # prompt pages in the index


_EVENTS = ("submitted", "completed", "rejected", "timed_out", "cancelled",
           "failed", "parked", "preempted", "resumed")


def _window_stats(values) -> dict:
    if not values:
        return {"count": 0}
    a = np.asarray(values, np.float64)
    return {"count": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


class DecodeMetrics:
    """The engine's metric families on the process-wide registry, under the
    reference's names (``paddle_decode_requests_total{server,event}``,
    ``paddle_decode_tokens_total``, ``paddle_decode_ttft_ms``,
    ``paddle_decode_inter_token_ms``, ``paddle_decode_step_ms{stage}``,
    ``paddle_decode_batch_occupancy``, ``paddle_decode_kv_pages{state}``,
    ``paddle_decode_kv_pool_bytes{dtype}``, the eviction, prefix and
    speculation counters), plus bounded windows that :meth:`snapshot`
    reads as one plain dict (its schema is the port's: count, mean, p50,
    p90, p99 and max a window)."""

    def __init__(self, name: str, max_batch: int, page_capacity: int,
                 window: int = 4096, registry=None):
        self.name = name
        self._lock = threading.Lock()
        reg = registry or default_registry()
        occ_buckets = sorted({1, 2, 4, 8, 16, 32, 64, 128,
                              max(1, int(max_batch))})
        self._f_events = reg.counter(
            "paddle_decode_requests_total",
            "generation request lifecycle events per engine",
            ("server", "event"))
        self._f_tokens = reg.counter(
            "paddle_decode_tokens_total",
            "tokens emitted by the decode engine", ("server",))
        self._f_inter = reg.histogram(
            "paddle_decode_inter_token_ms",
            "latency between consecutive streamed tokens of a sequence",
            ("server",))
        self._f_step = reg.histogram(
            "paddle_decode_step_ms",
            "device step durations by stage (prefill batch / decode "
            "iteration)", ("server", "stage"))
        self._f_occ = reg.histogram(
            "paddle_decode_batch_occupancy",
            "live lanes per decode iteration (continuous-batching "
            "utilization of the fixed [max_batch, 1] step)",
            ("server",), buckets=occ_buckets)
        self._f_pages = reg.gauge(
            "paddle_decode_kv_pages",
            "KV-cache page occupancy by state", ("server", "state"))
        self._f_pool_bytes = reg.gauge(
            "paddle_decode_kv_pool_bytes",
            "resident device bytes of the paged K/V pools (quantized "
            "pools include their scale planes)", ("server", "dtype"))
        self._f_evict = reg.counter(
            "paddle_decode_kv_page_evictions_total",
            "pages released by finished/cancelled sequences", ("server",))
        self._f_ttft = reg.histogram(
            "paddle_decode_ttft_ms",
            "time to first token: submit to first streamed token "
            "(prefix-cache hits collapse the prefill share)", ("server",))
        self._f_pfx_hits = reg.counter(
            "paddle_decode_prefix_hits_total",
            "admissions whose prompt reused cached prefix pages",
            ("server",))
        self._f_pfx_reused = reg.counter(
            "paddle_decode_prefix_tokens_reused_total",
            "prompt tokens served from the prefix cache instead of "
            "prefill", ("server",))
        self._f_spec_prop = reg.counter(
            "paddle_decode_spec_proposed_tokens_total",
            "draft-model tokens proposed to the verify step", ("server",))
        self._f_spec_acc = reg.counter(
            "paddle_decode_spec_accepted_tokens_total",
            "proposed tokens the target model accepted", ("server",))
        self._f_compile = reg.counter(
            "paddle_decode_compile_total",
            "decode-engine dispatch signatures by compile-cache result",
            ("server", "result"))
        for fam in (self._f_events, self._f_tokens, self._f_inter,
                    self._f_step, self._f_occ, self._f_pages,
                    self._f_pool_bytes, self._f_evict, self._f_ttft,
                    self._f_pfx_hits, self._f_pfx_reused,
                    self._f_spec_prop, self._f_spec_acc, self._f_compile):
            fam.clear(server=name)
        self._events = {e: self._f_events.labels(server=name, event=e)
                        for e in _EVENTS}
        self._c_tokens = self._f_tokens.labels(server=name)
        self._h_inter = self._f_inter.labels(server=name)
        self._h_step = {s: self._f_step.labels(server=name, stage=s)
                        for s in ("prefill", "decode")}
        self._h_occ = self._f_occ.labels(server=name)
        self._g_used = self._f_pages.labels(server=name, state="used")
        self._g_free = self._f_pages.labels(server=name, state="free")
        self._c_evict = self._f_evict.labels(server=name)
        self._h_ttft = self._f_ttft.labels(server=name)
        self._c_pfx_hits = self._f_pfx_hits.labels(server=name)
        self._c_pfx_reused = self._f_pfx_reused.labels(server=name)
        self._c_spec_prop = self._f_spec_prop.labels(server=name)
        self._c_spec_acc = self._f_spec_acc.labels(server=name)
        self._c_hit = self._f_compile.labels(server=name, result="hit")
        self._c_miss = self._f_compile.labels(server=name, result="miss")
        self._ttft = deque(maxlen=window)
        self._inter = deque(maxlen=window)
        self._step = {s: deque(maxlen=window) for s in ("prefill", "decode")}
        self._occ_sum = 0
        self._occ_n = 0
        self._page_capacity = int(page_capacity)
        self._pool_bytes = 0
        self._pool_dtype = "model"
        self._spec_greedy = [0, 0]      # greedy lanes: proposed, accepted

    def count(self, event: str, n: int = 1):
        self._events[event].inc(n)

    def observe_tokens(self, n: int):
        self._c_tokens.inc(int(n))

    def observe_inter_token(self, ms_list: Sequence[float]):
        ms_list = [float(m) for m in ms_list]
        if not ms_list:
            return
        with self._lock:
            self._inter.extend(ms_list)
        self._h_inter.observe_many(ms_list)

    def observe_step(self, stage: str, ms: float):
        with self._lock:
            self._step[stage].append(float(ms))
        self._h_step[stage].observe(float(ms))

    def observe_occupancy(self, n_active: int):
        with self._lock:
            self._occ_sum += int(n_active)
            self._occ_n += 1
        self._h_occ.observe(n_active)

    def observe_ttft(self, ms: float):
        with self._lock:
            self._ttft.append(float(ms))
        self._h_ttft.observe(float(ms))

    def set_kv_pages(self, used: int, free: int):
        self._g_used.set(int(used))
        self._g_free.set(int(free))

    def observe_evictions(self, n_pages: int):
        self._c_evict.inc(int(n_pages))

    def set_kv_pool_bytes(self, nbytes: int, dtype: str = ""):
        with self._lock:
            self._pool_bytes = int(nbytes)
            self._pool_dtype = dtype or "model"
        self._f_pool_bytes.labels(server=self.name,
                                  dtype=self._pool_dtype).set(int(nbytes))

    def observe_compile(self, hit: bool):
        (self._c_hit if hit else self._c_miss).inc()

    def observe_prefix_hit(self, tokens_reused: int):
        self._c_pfx_hits.inc()
        self._c_pfx_reused.inc(int(tokens_reused))

    def observe_spec(self, proposed: int, accepted: int,
                     greedy: bool = False):
        self._c_spec_prop.inc(int(proposed))
        self._c_spec_acc.inc(int(accepted))
        if greedy:
            with self._lock:
                self._spec_greedy[0] += int(proposed)
                self._spec_greedy[1] += int(accepted)

    def snapshot(self) -> dict:
        proposed = int(self._c_spec_prop.value)
        accepted = int(self._c_spec_acc.value)
        used = int(self._g_used.value)
        with self._lock:
            return {
                "server": self.name,
                "counters": {e: int(c.value)
                             for e, c in self._events.items()},
                "tokens_total": int(self._c_tokens.value),
                "ttft_ms": _window_stats(self._ttft),
                "inter_token_ms": _window_stats(self._inter),
                "step_ms": {s: _window_stats(w)
                            for s, w in self._step.items()},
                "batch_occupancy": {
                    "mean": (self._occ_sum / self._occ_n
                             if self._occ_n else 0.0),
                    "steps": self._occ_n},
                "kv_pages": {"capacity": self._page_capacity,
                             "used": used,
                             "free": self._page_capacity - used,
                             "evicted_total": int(self._c_evict.value),
                             "pool_bytes": self._pool_bytes,
                             "pool_dtype": self._pool_dtype},
                "compile_cache": {"hits": int(self._c_hit.value),
                                  "misses": int(self._c_miss.value)},
                "prefix": {"hits": int(self._c_pfx_hits.value),
                           "tokens_reused": int(self._c_pfx_reused.value)},
                "spec": {"proposed": proposed,
                         "accepted": accepted,
                         "acceptance_rate": accepted / max(1, proposed),
                         # greedy lanes alone: with the target as its own
                         # draft, only rounding can reject there
                         "greedy_acceptance_rate": (
                             self._spec_greedy[1]
                             / max(1, self._spec_greedy[0]))},
            }


class GenerationServer:
    """Continuous-batching decode engine over one cache-capable causal LM
    (``GPTForCausalLM``).

    ``submit_generate(prompt, ...) -> StreamingFuture`` with bounded-queue
    backpressure and scheduling deadlines; knobs default to the
    ``FLAGS_decode_*`` flags (framework/flags.py): the prefix cache is on
    unless ``prefix_cache=False`` or the flag says otherwise, and a
    ``draft_model`` turns on speculative decoding with ``spec_k`` (default
    ``FLAGS_decode_spec_k``) proposals a step. ``device`` (default: the
    CUDA device; ``"cpu"`` must be asked for) must be the model's and the
    draft's. The models are put in eval mode; their parameters are read
    live at each step. ``donate`` is accepted for the reference's surface
    and has no effect: the port updates the pools in place, which is what
    the reference's donation buys. ``scheduler`` (an
    ``AdmissionController``) turns on per-tenant quotas, weighted-fair
    admission and priority-aware page preemption; ``telemetry_port``
    (default ``FLAGS_serving_telemetry_port``; -1 off, 0 ephemeral)
    attaches the telemetry endpoint, and a port that cannot be bound raises
    ``OSError``.
    """

    def __init__(self, model, *, max_batch: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 queue_capacity: Optional[int] = None,
                 default_timeout_ms: Optional[float] = None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0,
                 donate: Optional[bool] = None,
                 name: str = "generate",
                 telemetry_port: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft_model=None,
                 spec_k: Optional[int] = None,
                 scheduler=None,
                 device=None,
                 start: bool = True):
        self.device = resolve_device(device)
        model.eval()
        self.model = model
        spec = model.kv_cache_spec()
        self.max_batch = int(max_batch if max_batch is not None
                             else flag_value("FLAGS_decode_max_batch"))
        self.page_size = int(page_size if page_size is not None
                             else flag_value("FLAGS_decode_page_size"))
        self.max_seq_len = int(max_seq_len if max_seq_len is not None
                               else spec["max_seq_len"])
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.kv_dtype = str(flag_value("FLAGS_decode_kv_dtype") or "")
        pool_dtype = resolve_kv_dtype(self.kv_dtype)
        nh, hd = spec["num_heads"], spec["head_dim"]
        f32_tok = kv_pool_bytes(1, 1, nh, hd, None)
        cur_tok = kv_pool_bytes(1, 1, nh, hd, self.kv_dtype or None)
        # as the reference's auto sizing: the pool is priced in its storage
        # flag ('' = float32, whatever the model's dtype), and int8 or bf16
        # pools get 2x pages for the same budget
        self.kv_capacity_factor = max(1, min(2, f32_tok // max(cur_tok, 1)))
        if num_pages is None:
            num_pages = int(flag_value("FLAGS_decode_kv_pages"))
        if not num_pages:
            num_pages = 1 + (self.max_batch * self.pages_per_seq
                             * self.kv_capacity_factor)
        self.default_timeout_ms = default_timeout_ms \
            if default_timeout_ms is not None \
            else (flag_value("FLAGS_decode_default_timeout_ms") or None)
        cap = queue_capacity if queue_capacity is not None \
            else flag_value("FLAGS_decode_queue_capacity")
        self.queue_capacity = int(cap)
        if seq_buckets is None:
            seq_buckets, b = [], 8
            while b < self.max_seq_len:
                seq_buckets.append(b)
                b <<= 1
            seq_buckets.append(self.max_seq_len)
        self.policy = ShapeBucketPolicy(
            max_batch_size=self.max_batch, pad_batch=True,
            seq_buckets=seq_buckets)
        self.decoder = CachedDecoder(
            model, max_batch=self.max_batch, page_size=self.page_size,
            pages_per_seq=self.pages_per_seq,
            max_positions=self.max_seq_len, kv_dtype=self.kv_dtype,
            device=self.device, donate=donate)
        self.kv = PagedKVCache(model, num_pages=int(num_pages),
                               page_size=self.page_size, dtype=pool_dtype)
        # ---- shared-prefix KV reuse (radix index over full pages)
        if prefix_cache is None:
            prefix_cache = bool(flag_value("FLAGS_decode_prefix_cache"))
        self.prefix = PrefixCache(self.kv) if prefix_cache else None
        # ---- speculative decoding (the draft proposes, the target verifies)
        self.spec_k = int(spec_k if spec_k is not None
                          else flag_value("FLAGS_decode_spec_k"))
        if draft_model is None:
            self.spec_k = 0
        self.draft: Optional[CachedDecoder] = None
        self._draft_k = self._draft_v = None
        if self.spec_k:
            if not supports_cached_decode(draft_model):
                raise TypeError("draft_model must support KV-cached decode "
                                "(forward(cache=) + init_kv_pools)")
            if not same_device(draft_model.device, self.device):
                raise ValueError(f"the draft model is on "
                                 f"{draft_model.device}, the engine on "
                                 f"{self.device}")
            dspec = draft_model.kv_cache_spec()
            if dspec["max_seq_len"] < self.max_seq_len:
                raise ValueError(
                    f"draft model max_seq_len={dspec['max_seq_len']} is "
                    f"shorter than the engine's "
                    f"max_seq_len={self.max_seq_len}")
            draft_model.eval()
            # the draft shares the target's block tables 1:1 (its own
            # pools, the same page geometry), so prefix-cache hits reuse
            # draft K/V for free and rollback is the same truncation
            self.draft = CachedDecoder(
                draft_model, max_batch=self.max_batch,
                page_size=self.page_size, pages_per_seq=self.pages_per_seq,
                max_positions=self.max_seq_len, kv_dtype=self.kv_dtype,
                device=self.device, donate=donate)
            self._draft_k, self._draft_v = draft_model.init_kv_pools(
                self.kv.num_pages, self.page_size, pool_dtype)
        self.metrics = DecodeMetrics(name, self.max_batch, self.kv.capacity)
        self.metrics.set_kv_pages(0, self.kv.capacity)
        self.metrics.set_kv_pool_bytes(self.kv.pool_bytes(), self.kv_dtype)
        # ---- multi-tenant admission: an AdmissionController adds
        # per-tenant token-bucket quotas, weighted-fair queue order and
        # priority-aware page-pressure preemption; None = FIFO engine
        self.scheduler = scheduler
        if scheduler is not None:
            from ..scheduling.schedz import register_controller
            register_controller(scheduler)
        # ONE Condition is both the engine lock and the wakeup channel
        self._lock = threading.Condition()
        self._queue: "deque[_Request]" = deque()
        self._slots: List[Optional[_ActiveSeq]] = [None] * self.max_batch
        self._tables = np.zeros((self.max_batch, self.pages_per_seq),
                                np.int32)
        self._closed = False
        self._abort = False
        self._loop_running = False
        self._worker: Optional[threading.Thread] = None
        self._steps = 0
        self._span_q: List[tuple] = []      # spans to record, lock held
        # readiness (distinct from liveness): with the warmup gate on
        # (FLAGS_serving_ready_requires_warmup), the engine reports
        # not-ready until warmup() or mark_ready()
        self._ready_gate = bool(
            flag_value("FLAGS_serving_ready_requires_warmup"))
        self._warmed = threading.Event()
        # (site, ((shape, dtype), ...)) of every dispatch signature this
        # engine ran, in first-run order (the reference's _note_dispatch
        # records); warmup counts the ones new to this engine
        self.dispatch_signatures: List[tuple] = []
        self._signature_set = set()
        self._manifest = self._init_manifest(name)
        self._manifest_recorded = set()
        self.telemetry = self._attach_telemetry(telemetry_port, name)
        with _ENGINES_LOCK:
            _ENGINES.add(self)
        if start:
            self.start()

    # ------------------------------------------------------ telemetry
    def _attach_telemetry(self, telemetry_port, name):
        port = telemetry_port if telemetry_port is not None \
            else flag_value("FLAGS_serving_telemetry_port")
        if port is None or int(port) < 0:
            return None
        from ... import observability
        srv = observability.start_telemetry_server(port=int(port))
        observability.add_health_check(f"decode:{name}", self._health)
        observability.add_readiness_check(f"decode:{name}",
                                          self._readiness)
        return srv

    def _init_manifest(self, name):
        if not str(flag_value("FLAGS_compile_cache_dir") or ""):
            return None
        try:
            from ...compile_cache import WarmupManifest, default_cache
            cache = default_cache()
            if cache is None:
                return None
            return WarmupManifest(WarmupManifest.default_path(
                cache.directory, f"decode-{name}",
                self.decoder.fingerprint()))
        except Exception:  # noqa: BLE001 - optimization artifact only
            return None

    @property
    def warmup_manifest(self):
        """The live WarmupManifest (or None without a compile cache):
        the decode, prefill, chunked and verify signatures traffic
        dispatched, written through as they first appear."""
        return self._manifest

    def _health(self):
        if self._closed:
            return False, "shut down"
        w = self._worker
        if w is not None and not w.is_alive() and not self._loop_running:
            return False, "worker thread died"
        return True, {"queue_depth": self.queue_depth,
                      "active_sequences": self.active_sequences}

    @property
    def ready(self) -> bool:
        """Traffic readiness (as ``InferenceServer.ready``): live, and,
        when the ``FLAGS_serving_ready_requires_warmup`` gate is on,
        warmed up."""
        if self._closed:
            return False
        return self._warmed.is_set() or not self._ready_gate

    def mark_ready(self):
        self._warmed.set()

    def _readiness(self):
        return self.ready, {"warmed": self._warmed.is_set(),
                            "gated": self._ready_gate}

    def statusz(self) -> dict:
        """One engine's /statusz section: page accounting (with the
        refcount-leak check), prefix-cache and speculative state, and
        under a scheduler the queued requests per tenant."""
        with self._lock:
            out = {
                "closed": self._closed,
                "queue_depth": len(self._queue),
                "active_sequences": sum(
                    1 for s in self._slots if s is not None),
                "kv_leak_check": self.kv.leak_check(),
                "spec_k": self.spec_k,
            }
            if self.prefix is not None:
                out["prefix_cache"] = self.prefix.stats()
            if self.scheduler is not None:
                depths: Dict[str, int] = {}
                for q in self._queue:
                    depths[q.tenant] = depths.get(q.tenant, 0) + 1
                out["tenant_queue_depth"] = depths
        return out

    def refresh_params(self):
        """After the model's weights changed: the decoders read live
        parameters, so only the prefix index must go (its pages hold K/V
        computed with the old weights; serving them would be silent
        staleness). In-flight sequences keep streaming."""
        self.clear_prefix_cache()

    def clear_prefix_cache(self) -> int:
        """Drop every cached prefix page back to the free list (pages shared
        with in-flight sequences stay until those finish). Returns the
        number of pages freed."""
        if self.prefix is None:
            return 0
        with self._lock:
            n = self.prefix.clear()
            if n:
                self.metrics.set_kv_pages(self.kv.used_pages,
                                          self.kv.free_pages)
            return n

    # ------------------------------------------------------ observability
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_sequences(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s is not None)

    def leak_check(self) -> dict:
        """KV page accounting (PagedKVCache.leak_check)."""
        with self._lock:
            return self.kv.leak_check()

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        with self._lock:
            if self.prefix is not None:
                snap["prefix"].update(self.prefix.stats())
            snap["spec"]["k"] = self.spec_k
            snap["decode_steps"] = self._steps
            snap["kv_leak_check"] = self.kv.leak_check()
        return snap

    # ------------------------------------------------------ lifecycle
    def start(self):
        with self._lock:
            if self._closed:
                raise ServerClosedError("engine already shut down")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._loop, name=f"engine-{self.metrics.name}",
                    daemon=True)
                self._worker.start()
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests; ``drain`` (default) lets queued and
        in-flight sequences finish, otherwise both are failed with
        ServerClosedError. Idempotent."""
        with self._lock:
            self._closed = True
            if not drain:
                self._abort = True
            self._lock.notify_all()
        w = self._worker
        if w is not None and w.is_alive() and \
                w is not threading.current_thread():
            w.join(timeout)
        elif not self._loop_running:
            # never-started engine (start=False): run the loop inline so
            # queued requests still drain (or abort)
            self._loop()
        if self.telemetry is not None:
            from ...observability import (remove_health_check,
                                          remove_readiness_check)
            remove_health_check(f"decode:{self.metrics.name}")
            remove_readiness_check(f"decode:{self.metrics.name}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
        return False

    # ------------------------------------------------------ submission
    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        temperature: float = 0.0,
                        timeout_ms: Optional[float] = None,
                        seed: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        tenant: Optional[str] = None
                        ) -> StreamingFuture:
        """Enqueue one prompt; returns the token stream. ``timeout_ms`` is a
        SCHEDULING deadline: a request still queued past it fails with
        DeadlineExceededError; once prefilled, the stream runs to
        completion. ``deadline_ms`` is the HARD end-to-end budget: a stream
        still decoding past it is evicted at the next batch re-form.
        ``tenant`` selects the multi-tenant envelope when the engine has a
        scheduler (untagged maps to ``default``): an over-quota submission
        raises the typed per-tenant QuotaExceededError. Raises
        QueueFullError at capacity, ServerClosedError after shutdown,
        ValueError for prompts that leave no room to generate."""
        if self._closed:
            raise ServerClosedError("engine is shut down")
        prompt = np.asarray(
            prompt.cpu().numpy() if isinstance(prompt, torch.Tensor)
            else prompt).astype(np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_seq_len:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to generate "
                f"within max_seq_len={self.max_seq_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        ctx = tracing.request_context()
        prio_rank, tname = 1, "default"
        if self.scheduler is not None:
            pol = self.scheduler.policy.lookup(tenant)
            tname, prio_rank = pol.tenant, pol.rank
            # token-denominated quota: one submission spends prompt +
            # generation budget from the tenant's bucket
            cost = float(prompt.size + max_new_tokens)
            if not self.scheduler.try_admit(tname, cost):
                self.metrics.count("rejected")
                if ctx is not None:
                    tracing.record_span(
                        ctx.child(), "generate::shed", stage="shed",
                        start_unix_ns=time.time_ns(), duration_ms=0.0,
                        status="error",
                        attrs={"server": self.metrics.name,
                               "tenant": tname,
                               "error": "QuotaExceededError"},
                        root=True)
                raise QuotaExceededError(
                    f"tenant {tname!r} exceeded its token quota "
                    f"({pol.rate:g}/s, burst {pol.burst:g})", tenant=tname)
        req = _Request(prompt, max_new_tokens, temperature, seed,
                       timeout_ms if timeout_ms is not None
                       else self.default_timeout_ms,
                       trace=ctx.child() if ctx is not None else None,
                       deadline_ms=deadline_ms,
                       tenant=tname, prio_rank=prio_rank)
        with self._lock:
            if self._closed:
                raise ServerClosedError("engine is shut down")
            full = len(self._queue) >= self.queue_capacity
            if full:
                self.metrics.count("rejected")
            else:
                self._queue.append(req)
                self.metrics.count("submitted")
                self._lock.notify_all()
        if full:
            if req.trace is not None:
                tracing.record_span(
                    req.trace, "generate::shed", stage="shed",
                    start_unix_ns=req.t_wall_ns, duration_ms=0.0,
                    status="error",
                    attrs={"server": self.metrics.name,
                           "error": "QueueFullError"}, root=True)
            raise QueueFullError(
                f"generation queue at capacity ({self.queue_capacity})")
        return req.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 timeout_ms: Optional[float] = None,
                 seed: Optional[int] = None) -> List[int]:
        """Synchronous convenience: submit and block for the full
        generated-token list."""
        return self.submit_generate(prompt, max_new_tokens, temperature,
                                    timeout_ms, seed).result()

    # ------------------------------------------------------ warmup
    def warmup_from_manifest(self, path: Optional[str] = None) -> int:
        """Replay the persisted decode, prefill, chunked and verify
        signatures a previous process's traffic dispatched (each one a
        compile-cache hit on a warm directory), within this engine's
        ``max_batch`` and ``max_seq_len``. Returns the count run for the
        first time, as ``warmup``; 0 when no manifest exists."""
        if path is not None:
            from ...compile_cache import WarmupManifest
            manifest = WarmupManifest(path)
        else:
            manifest = self._manifest
        if manifest is None:
            return 0
        fresh = 0
        for site, warm in (("generate_prefill", self._warm_prefill),
                           ("generate_chunked", self._warm_chunked)):
            for spec in manifest.specs(site=site):
                (rows, seq) = spec["feeds"][0][0]
                if rows > self.max_batch or seq > self.max_seq_len:
                    continue
                fresh += warm(int(rows), int(seq))
        if manifest.specs(site="generate_decode"):
            fresh += self._warm_decode()
        if self.spec_k and any(
                tuple(spec["feeds"][0][0]) == (self.max_batch,
                                               self.spec_k + 1)
                for spec in manifest.specs(site="generate_verify")):
            fresh += self._warm_verify()
        self._warmed.set()
        return fresh

    def warmup(self, seq_buckets: Optional[Sequence[int]] = None,
               batch_buckets: Optional[Sequence[int]] = None) -> int:
        """Run the decode lattice once on the device before traffic: the
        one decode-step shape (plus the verify step under speculation)
        and every (power-of-two rows, seq bucket) prefill shape admission
        can dispatch, with the chunked (suffix-prefill) lattice beside it
        when the prefix cache is on; a draft model runs each signature
        too. On the card a shape's first run pays the kernels' first
        launches and the caching allocator's growth, which the
        reference's XLA compile stood for. Returns how many of the
        signatures were new to this engine, and turns the readiness gate
        on."""
        fresh = self._warm_decode()
        if self.spec_k:
            fresh += self._warm_verify()
        seqs = list(seq_buckets if seq_buckets is not None
                    else (self.policy.seq_buckets or []))
        if batch_buckets is None:
            batch_buckets, r = [], 1
            while r < self.max_batch:
                batch_buckets.append(r)
                r <<= 1
            batch_buckets.append(self.max_batch)
        for s in seqs:
            for r in batch_buckets:
                fresh += self._warm_prefill(int(r), int(s))
                if self.prefix is not None:
                    fresh += self._warm_chunked(int(r), int(s))
        self._warmed.set()
        return fresh

    def _warm(self, site: str, fn: str, args, feeds) -> int:
        """One warmup dispatch of decoder entry point ``fn`` (and the
        draft's): the pools stay in place, dead rows write to the trash
        page. Returns the signatures new to this engine."""
        out, self.kv.k, self.kv.v = getattr(self.decoder, fn)(
            *args, self.kv.k, self.kv.v)
        fresh = int(self._note_dispatch(site, feeds, record=False))
        if self.draft is not None and site != "generate_verify":
            _, self._draft_k, self._draft_v = getattr(self.draft, fn)(
                *args, self._draft_k, self._draft_v)
            fresh += int(self._note_dispatch("draft_" + site, feeds,
                                             record=False))
        out.float().cpu()       # surface a failed warmup here, loudly
        return fresh

    def _warm_decode(self) -> int:
        b = self.max_batch
        return self._warm("generate_decode", "decode", (
            np.zeros(b, np.int64), np.zeros(b, np.int32),
            np.zeros(b, bool), np.zeros(b, np.int32),
            np.zeros_like(self._tables)), [
            ((b,), "int64"), ((b,), "int32"), ((b,), "bool"),
            ((b,), "int32"), (self._tables.shape, "int32")])

    def _warm_prefill(self, rows: int, seq: int) -> int:
        ids = np.zeros((rows, seq), np.int64)
        lens = np.zeros(rows, np.int32)
        tables = np.zeros((rows, self.pages_per_seq), np.int32)
        return self._warm("generate_prefill", "prefill", (ids, lens, tables),
                          [(ids.shape, "int64"), (lens.shape, "int32"),
                           (tables.shape, "int32")])

    def _warm_window(self, site: str, fn: str, rows: int, seq: int) -> int:
        ids = np.zeros((rows, seq), np.int64)
        start = np.zeros(rows, np.int32)
        seg = np.zeros(rows, np.int32)
        tables = np.zeros((rows, self.pages_per_seq), np.int32)
        return self._warm(site, fn, (ids, start, seg, tables),
                          [(ids.shape, "int64"), (start.shape, "int32"),
                           (seg.shape, "int32"), (tables.shape, "int32")])

    def _warm_chunked(self, rows: int, seq: int) -> int:
        return self._warm_window("generate_chunked", "prefill_chunked",
                                 rows, seq)

    def _warm_verify(self) -> int:
        """The one [max_batch, spec_k + 1] verify signature."""
        return self._warm_window("generate_verify", "verify",
                                 self.max_batch, self.spec_k + 1)

    def _note_dispatch(self, site: str, feeds, record: bool = True
                       ) -> bool:
        """Record a dispatch signature and count it in the snapshot's
        ``compile_cache`` section (target sites); True when it is new to
        this engine. TRAFFIC dispatches (``record``; not warmup replays)
        persist their signature in the warmup manifest, so a restarted
        engine warms exactly the observed lattice."""
        key = (site, tuple((tuple(int(d) for d in shape), str(dt))
                           for shape, dt in feeds))
        draft = site.startswith("draft_")
        with self._lock:
            new = key not in self._signature_set
            if new:
                self._signature_set.add(key)
                self.dispatch_signatures.append(key)
        if not draft:
            hit = not new or \
                self.decoder.cache_outcomes.get(site) == "hit"
            self.metrics.observe_compile(hit=hit)
        if record and not draft and self._manifest is not None \
                and key not in self._manifest_recorded:
            self._manifest_recorded.add(key)
            self._manifest.record(feeds, site=site)
        return new

    # ------------------------------------------------------ worker
    def _loop(self):
        with self._lock:
            self._loop_running = True
        try:
            # grad mode is thread-local: the worker enters inference mode
            # itself
            with torch.inference_mode():
                while True:
                    self._admit_and_prefill()
                    with self._lock:
                        self._evict_expired_streams()
                        active = [s for s in self._slots if s is not None]
                        if self._abort:
                            self._do_abort()
                            return
                        if not active:
                            if self._closed and not self._queue:
                                return
                            self._lock.wait(0.05)
                            continue
                    self._flush_spans()
                    if self.draft is not None:
                        self._spec_iteration(active)
                    else:
                        self._decode_iteration(active)
                    self._flush_spans()
        finally:
            with self._lock:
                self._loop_running = False
            self._flush_spans()

    # ---- spans: queued under the engine lock, recorded outside it ----
    def _queue_span(self, ctx, name: str, **kw):
        """Queue one span for recording (lock held): the tracing layer's
        own lock is never taken under the engine's."""
        self._span_q.append((ctx, name, kw))

    def _flush_spans(self):
        with self._lock:
            if not self._span_q:
                return
            pending, self._span_q = self._span_q, []
        for ctx, name, kw in pending:
            tracing.record_span(ctx, name, **kw)

    def _trace_finish(self, seqs: List[_ActiveSeq], status: str,
                      finish_reason: Optional[str] = None,
                      error: Optional[str] = None):
        """Queue each traced sequence's ``generate::request`` root span
        (the whole-stream envelope; lock held). An error status
        tail-promotes an unsampled trace."""
        now = time.time_ns()
        for seq in seqs:
            r = seq.req
            if r.trace is None:
                continue
            attrs = {"server": self.metrics.name,
                     "prompt_tokens": len(r.prompt),
                     "tokens": seq.n_generated}
            if finish_reason:
                attrs["finish_reason"] = finish_reason
            if error:
                attrs["error"] = error
            self._queue_span(
                r.trace, "generate::request", stage="request",
                start_unix_ns=r.t_wall_ns,
                duration_ms=max(0.0, (now - r.t_wall_ns) / 1e6),
                status=status, attrs=attrs, root=True)

    def _evict_expired_streams(self):
        """Hard-deadline check at batch re-form (lock held)."""
        now = time.monotonic()
        for seq in list(self._slots):
            if seq is None or not seq.req.hard_expired(now):
                continue
            seq.req.future._fail(
                DeadlineExceededError(
                    f"deadline budget expired after {seq.n_generated} "
                    f"generated token(s); stream evicted"),
                reason="deadline")
            self._release(seq, "timed_out")
            self._trace_finish([seq], "error",
                               error="DeadlineExceededError",
                               finish_reason="deadline")

    def _preempt_for_pages(self, rank: int, need: int) -> bool:
        """Priority-aware page pressure (lock held): park in-flight streams
        of a strictly lower priority class (a higher rank number), lowest
        class first and youngest first within a class, until ``need`` pages
        are free. Their pages go back (``leak_check`` stays clean) and each
        is re-queued to resume from its full token history. Returns True
        when the reservation now fits; equal or higher classes are never
        touched."""
        if need > self.kv.free_pages + sum(
                len(s.pages) for s in self._slots
                if s is not None and s.req.prio_rank > rank):
            return False        # not even parking everyone would fit
        victims = [s for s in self._slots
                   if s is not None and s.req.prio_rank > rank]
        victims.sort(key=lambda s: (-s.req.prio_rank, -s.req.submit_t))
        for seq in victims:
            if self.kv.free_pages >= need:
                break
            self._park(seq)
        return self.kv.free_pages >= need

    def _park(self, seq: _ActiveSeq):
        """Preempt one in-flight stream (lock held): free its pages and
        lane, then re-queue it to resume. The resumed request's prompt is
        the full token history, so a later prefill (a chunked one over the
        prompt pages the prefix cache still holds) rebuilds the K/V and the
        same future keeps streaming where it left off. When it cannot
        resume (engine closing, queue full, or the history already fills
        max_seq_len) the stream fails with the typed per-tenant
        QuotaExceededError instead of hanging."""
        self._release(seq, "parked")
        r = seq.req
        history = list(seq.history)     # prompt + every emitted token
        resumable = (not self._closed
                     and len(self._queue) < self.queue_capacity
                     and len(history) < self.max_seq_len
                     and r.max_new - seq.n_generated >= 1)
        if not resumable:
            self.metrics.count("preempted")
            r.future._fail(
                QuotaExceededError(
                    f"stream preempted by a higher priority class after "
                    f"{seq.n_generated} token(s); resume unavailable",
                    tenant=r.tenant),
                reason="preempted")
            self._trace_finish([seq], "error", error="QuotaExceededError",
                               finish_reason="preempted")
            return
        nr = _Request(np.asarray(history, np.int64),
                      r.max_new - seq.n_generated, r.temperature,
                      None, None, trace=r.trace,
                      tenant=r.tenant, prio_rank=r.prio_rank,
                      n_done=r.n_done + seq.n_generated)
        # the resumed request is the original request: the same future,
        # RNG stream, deadlines and submit time (so the scheduling
        # deadline keeps covering the whole stream)
        nr.future = r.future
        nr.rng = r.rng
        nr.submit_t = r.submit_t
        nr.deadline = r.deadline
        nr.hard_deadline = r.hard_deadline
        nr.t_wall_ns = r.t_wall_ns
        self._queue.append(nr)

    def _do_abort(self):
        """drain=False shutdown: fail everything still live (lock held)."""
        err = ServerClosedError("engine shut down before completion")
        for req in self._queue:
            req.future._fail(err, reason="shutdown")
            self.metrics.count("failed")
        self._queue.clear()
        for seq in list(self._slots):
            if seq is not None:
                seq.req.future._fail(err, reason="shutdown")
                self._release(seq, "failed")
                self._trace_finish([seq], "error", error="ServerClosedError")

    # ---- admission + prefill ----
    def _admit_and_prefill(self):
        admitted: List[_ActiveSeq] = []
        now = time.monotonic()
        with self._lock:
            live = deque()
            for req in self._queue:
                if req.expired(now):
                    self.metrics.count("timed_out")
                    req.future._fail(
                        DeadlineExceededError(
                            "deadline passed before the request could be "
                            "scheduled"), reason="timed_out")
                    if req.trace is not None:
                        self._queue_span(
                            req.trace, "generate::queue", stage="queue",
                            start_unix_ns=req.t_wall_ns,
                            duration_ms=(now - req.submit_t) * 1e3,
                            status="error",
                            attrs={"server": self.metrics.name,
                                   "error": "DeadlineExceededError"},
                            root=True)
                else:
                    live.append(req)
            self._queue = live
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            while self._queue and free_slots:
                # weighted-fair pick across tenants (priority classes
                # first) under a scheduler; FIFO otherwise
                idx = 0
                if self.scheduler is not None and len(self._queue) > 1:
                    sel = self.scheduler.select(self._queue)
                    idx = sel if sel is not None else 0
                req = self._queue[idx]
                max_total = min(len(req.prompt) + req.max_new,
                                self.max_seq_len)
                # the prefix index FIRST: matched full pages are shared
                # (retained); only the rest of the reservation comes from
                # the free list
                matched, shared = (0, [])
                if self.prefix is not None:
                    matched, shared = self.prefix.match(req.prompt)
                need = self.kv.pages_for(max_total) - len(shared)
                pages = self.kv.alloc(need)
                if pages is None and self.prefix is not None:
                    # pool pressure: reclaim LRU cache-only pages, then
                    # retry once. The matched pages are pinned meanwhile:
                    # a parked stream's prompt pages are cache-only too,
                    # and evicting them would hand the same page out
                    # again as one of this request's own (the reference
                    # engine maps such a page twice in one block table)
                    self.kv.retain(shared)
                    try:
                        if self.prefix.evict(need - self.kv.free_pages):
                            pages = self.kv.alloc(need)
                    finally:
                        self.kv.release(shared)
                if pages is None and self.scheduler is not None:
                    # priority-aware page pressure: park strictly lower
                    # priority in-flight streams (batch before standard;
                    # realtime is never touched) until the reservation
                    # fits, then retry once
                    if self._preempt_for_pages(req.prio_rank, need):
                        pages = self.kv.alloc(need)
                if pages is None:
                    break       # head-of-line until pages free up
                # between taking the reservation and publishing it into
                # self._slots no failure may keep the references
                try:
                    self.kv.retain(shared)
                except BaseException:
                    self.kv.release(pages)
                    raise
                try:
                    if self.prefix is not None:
                        self.prefix.note_admission(matched)
                        if matched:
                            self.metrics.observe_prefix_hit(matched)
                    del self._queue[idx]
                    slot = free_slots.pop(0)
                    seq = _ActiveSeq(req, slot, shared + pages, max_total,
                                     prefix_len=matched)
                    self._slots[slot] = seq
                except BaseException:
                    self.kv.release(shared + pages)
                    raise
                self._tables[slot, :] = 0
                self._tables[slot, :len(seq.pages)] = seq.pages
                admitted.append(seq)
            if admitted:
                self.metrics.set_kv_pages(self.kv.used_pages,
                                          self.kv.free_pages)
        if not admitted:
            return
        t_adm = time.time_ns()
        for seq in admitted:
            if seq.req.trace is not None:
                tracing.record_span(
                    seq.req.trace, "generate::queue", stage="queue",
                    start_unix_ns=seq.req.t_wall_ns,
                    duration_ms=max(0.0, (t_adm - seq.req.t_wall_ns) / 1e6),
                    attrs={"server": self.metrics.name, "slot": seq.slot,
                           "pages": len(seq.pages)})
        # prefill OUTSIDE the lock: cold prompts grouped by prompt bucket
        # (causal attention over the window), prefix hits by SUFFIX bucket
        # (chunked attention over the cached prefix)
        cold: Dict[int, List[_ActiveSeq]] = {}
        hot: Dict[int, List[_ActiveSeq]] = {}
        for seq in admitted:
            n_suffix = len(seq.req.prompt) - seq.prefix_len
            bucket = min(self.policy.bucket_seq(n_suffix), self.max_seq_len)
            (hot if seq.prefix_len else cold).setdefault(
                bucket, []).append(seq)
        for bucket, seqs in cold.items():
            self._prefill_group(seqs, bucket)
        for bucket, seqs in hot.items():
            self._prefill_chunked_group(seqs, bucket)

    def _fail_group(self, seqs: List[_ActiveSeq], exc: BaseException):
        with self._lock:
            for seq in seqs:
                seq.req.future._fail(exc)
                self._release(seq, "failed")
            self._trace_finish(seqs, "error",
                               error=f"{type(exc).__name__}: {exc}")

    def _profile(self, ms: float, kind: str, occupancy: int,
                 device_ms: Optional[float] = None, kv_pages: bool = True,
                 attrs=None):
        """One ``stepprof`` envelope (profiling is garnish on the hot
        path: a failure there never fails a step)."""
        try:
            default_profiler().record_step(
                ms, kind=kind, step=self._steps, device_ms=device_ms,
                occupancy=occupancy,
                kv_pages_used=self.kv.used_pages if kv_pages else None,
                attrs=attrs, device=self.device)
        except Exception:  # noqa: BLE001
            pass

    def _trace_prefill(self, seqs: List[_ActiveSeq], t_wall: int, ms: float,
                       seq_bucket: int, chunked: bool):
        for seq in seqs:
            if seq.req.trace is not None:
                tracing.record_span(
                    seq.req.trace, "generate::prefill", stage="prefill",
                    start_unix_ns=t_wall, duration_ms=ms,
                    attrs={"server": self.metrics.name, "rows": len(seqs),
                           "seq_bucket": seq_bucket, "prefix_hit": chunked,
                           "tokens_reused": seq.prefix_len})

    def _prefill_group(self, seqs: List[_ActiveSeq], seq_bucket: int):
        rows = len(seqs)
        padded = min(self.policy.bucket_batch(rows), self.max_batch)
        ids = np.full((padded, seq_bucket), self.pad_token_id, np.int64)
        lens = np.zeros(padded, np.int32)
        tables = np.zeros((padded, self.pages_per_seq), np.int32)
        for i, seq in enumerate(seqs):
            p = seq.req.prompt
            ids[i, :len(p)] = p
            lens[i] = len(p)
            tables[i] = self._tables[seq.slot]
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        try:
            last, k2, v2 = self.decoder.prefill(ids, lens, tables, self.kv.k,
                                                self.kv.v)
            logits = last.float().cpu().numpy()
            self.kv.k, self.kv.v = k2, v2
            feeds = [(ids.shape, "int64"), (lens.shape, "int32"),
                     (tables.shape, "int32")]
            self._note_dispatch("generate_prefill", feeds)
            if self.draft is not None:
                _, self._draft_k, self._draft_v = self.draft.prefill(
                    ids, lens, tables, self._draft_k, self._draft_v)
                self._note_dispatch("draft_generate_prefill", feeds)
        except Exception as e:  # noqa: BLE001 - fault barrier: fail only
            self._fail_group(seqs, e)   # THIS group; the worker survives
            return
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe_step("prefill", ms)
        # one envelope per prefill group (the same kind for the chunked
        # path: one stream per step kind)
        self._profile(ms, "prefill", rows, device_ms=ms)
        self._trace_prefill(seqs, t_wall, ms, seq_bucket, chunked=False)
        self._publish_prompts(seqs)
        self._sample_and_emit(seqs, logits[:rows])

    def _prefill_chunked_group(self, seqs: List[_ActiveSeq], seq_bucket: int):
        """Suffix prefill for prefix-cache hits: the window holds only each
        prompt's unmatched tail; attention reaches the shared prefix pages
        through the block tables (kind "chunked")."""
        rows = len(seqs)
        padded = min(self.policy.bucket_batch(rows), self.max_batch)
        ids = np.full((padded, seq_bucket), self.pad_token_id, np.int64)
        start = np.zeros(padded, np.int32)
        seg = np.zeros(padded, np.int32)
        tables = np.zeros((padded, self.pages_per_seq), np.int32)
        for i, seq in enumerate(seqs):
            suffix = seq.req.prompt[seq.prefix_len:]
            ids[i, :len(suffix)] = suffix
            start[i] = seq.prefix_len
            seg[i] = len(suffix)
            tables[i] = self._tables[seq.slot]
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        try:
            last, k2, v2 = self.decoder.prefill_chunked(
                ids, start, seg, tables, self.kv.k, self.kv.v)
            logits = last.float().cpu().numpy()
            self.kv.k, self.kv.v = k2, v2
            feeds = [(ids.shape, "int64"), (start.shape, "int32"),
                     (seg.shape, "int32"), (tables.shape, "int32")]
            self._note_dispatch("generate_chunked", feeds)
            if self.draft is not None:
                _, self._draft_k, self._draft_v = self.draft.prefill_chunked(
                    ids, start, seg, tables, self._draft_k, self._draft_v)
                self._note_dispatch("draft_generate_chunked", feeds)
        except Exception as e:  # noqa: BLE001 - fault barrier, as above
            self._fail_group(seqs, e)
            return
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe_step("prefill", ms)
        self._profile(ms, "prefill", rows, device_ms=ms)
        self._trace_prefill(seqs, t_wall, ms, seq_bucket, chunked=True)
        self._publish_prompts(seqs)
        self._sample_and_emit(seqs, logits[:rows])

    def _publish_prompts(self, seqs: List[_ActiveSeq]):
        """Index each prefilled prompt's FULL pages so later admissions can
        share them. Runs after the prefill that wrote the pages (and the
        draft's, under speculation) was enqueued: later reads of those pages
        are ordered after the writes on the device's stream."""
        if self.prefix is None:
            return
        with self._lock:
            for seq in seqs:
                self.prefix.publish(seq.req.prompt, seq.pages,
                                    n_tokens=len(seq.req.prompt))
                seq.published = True

    # ---- one decode iteration ----
    def _decode_iteration(self, active: List[_ActiveSeq]):
        tokens = np.zeros(self.max_batch, np.int64)
        positions = np.zeros(self.max_batch, np.int32)
        mask = np.zeros(self.max_batch, bool)
        ctx_after = np.zeros(self.max_batch, np.int32)
        for seq in active:
            tokens[seq.slot] = seq.last_token
            positions[seq.slot] = seq.ctx
            mask[seq.slot] = True
            # decode attends over the context INCLUDING the token written
            ctx_after[seq.slot] = seq.ctx + 1
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        try:
            logits, k2, v2 = self.decoder.decode(
                tokens, positions, mask, ctx_after, self._tables,
                self.kv.k, self.kv.v)
            logits = logits.float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 - fault barrier: a model
            self._fail_group(active, e)  # error fails the in-flight
            return                       # sequences, not the engine
        self.kv.k, self.kv.v = k2, v2
        b = self.max_batch
        self._note_dispatch("generate_decode", [
            ((b,), "int64"), ((b,), "int32"), ((b,), "bool"),
            ((b,), "int32"), (self._tables.shape, "int32")])
        ms = (time.perf_counter() - t0) * 1e3
        self._steps += 1
        self.metrics.observe_step("decode", ms)
        self.metrics.observe_occupancy(len(active))
        # continuous step profiler: one envelope per decode iteration
        # (occupancy and KV pressure ride along); a straggler iteration
        # becomes an error span in /tracez
        self._profile(ms, "decode", len(active), device_ms=ms, attrs={
            "prefix_tokens_reused": self.prefix.tokens_reused
            if self.prefix is not None else 0})
        for seq in active:
            if seq.req.trace is not None:
                # per-iteration span; long streams are bounded by the
                # flight recorder's per-trace cap, not here
                tracing.record_span(
                    seq.req.trace, "generate::decode_step",
                    stage="decode_step", start_unix_ns=t_wall,
                    duration_ms=ms,
                    attrs={"server": self.metrics.name,
                           "step": seq.n_generated,
                           "occupancy": len(active)})
        for seq in active:
            seq.ctx += 1
        self._sample_and_emit(active, logits[[s.slot for s in active]])

    # ---- one speculative iteration: the draft proposes, the target verifies
    def _spec_iteration(self, active: List[_ActiveSeq]):
        """Draft-then-verify (Leviathan et al.): the draft proposes
        ``spec_k`` tokens per lane through its own paged pools (the same
        block tables), then the target scores the whole ``[last_accepted,
        d_1..d_k]`` window in ONE ``[max_batch, k + 1]`` verify step.
        Accept-and-resample on the host keeps the output distribution that
        of plain sampling; rejected tokens' K/V writes sit on the lane's
        reserved pages and are rolled back by truncating ``ctx`` /
        ``draft_ctx``."""
        b, k = self.max_batch, self.spec_k
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        try:
            draft_toks, draft_probs = self._draft_propose(active, k)
            draft_ms = (time.perf_counter() - t0) * 1e3
            ids = np.zeros((b, k + 1), np.int64)
            start = np.zeros(b, np.int32)
            seg = np.zeros(b, np.int32)
            for s in active:
                ids[s.slot, 0] = s.last_token
                ids[s.slot, 1:] = draft_toks[s.slot]
                start[s.slot] = s.ctx
                seg[s.slot] = k + 1
            vlogits, k2, v2 = self.decoder.verify(
                ids, start, seg, self._tables, self.kv.k, self.kv.v)
            vlogits = vlogits.float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 - fault barrier: a model
            self._fail_group(active, e)  # error fails the in-flight
            return                       # sequences, not the engine
        self.kv.k, self.kv.v = k2, v2
        self._note_dispatch("generate_verify", [
            (ids.shape, "int64"), (start.shape, "int32"),
            (seg.shape, "int32"), (self._tables.shape, "int32")])
        ms = (time.perf_counter() - t0) * 1e3
        self._steps += 1
        self.metrics.observe_step("decode", ms)
        self.metrics.observe_occupancy(len(active))
        toks_lists: List[List[int]] = []
        accs: List[int] = []
        for s in active:
            remaining = min(s.req.max_new - s.n_generated,
                            s.max_total - s.ctx)
            emitted, acc = accept_tokens(
                vlogits[s.slot], draft_toks[s.slot],
                draft_probs.get(s.slot), s.req.temperature, s.req.rng,
                max_emit=remaining, eos_token_id=self.eos_token_id)
            self.metrics.observe_spec(k, acc, s.req.temperature <= 0.0)
            s.ctx += len(emitted)
            # rollback by truncation: positions past the accepted stream
            # hold rejected K/V in both pools; the shrunken ctx masks them
            # and the next write overwrites them in place
            s.draft_ctx = min(s.draft_ctx, s.ctx)
            toks_lists.append(emitted)
            accs.append(acc)
        self._profile(ms, "decode", len(active), device_ms=ms, attrs={
            "spec_proposed": k * len(active), "spec_accepted": sum(accs),
            "prefix_tokens_reused": self.prefix.tokens_reused
            if self.prefix is not None else 0})
        # the verify window alone (the iteration less the draft's
        # proposal) as a kind of its own
        self._profile(max(ms - draft_ms, 0.0), "verify", len(active),
                      kv_pages=False, attrs={"draft_ms": round(draft_ms, 4)})
        for seq, toks, acc in zip(active, toks_lists, accs):
            if seq.req.trace is not None:
                tracing.record_span(
                    seq.req.trace, "generate::verify", stage="verify",
                    start_unix_ns=t_wall, duration_ms=ms,
                    attrs={"server": self.metrics.name, "proposed": k,
                           "accepted": acc, "emitted": len(toks),
                           "draft_ms": round(draft_ms, 3),
                           "occupancy": len(active)})
        self._emit_batch(active, toks_lists)

    def _draft_propose(self, active: List[_ActiveSeq], k: int):
        """Run the draft ``k`` single-token steps (the same ``[max_batch,
        1]`` shape each time), sampling each lane's proposal from the draft
        distribution with the request's own RNG. Lanes whose draft pools lag
        the target context (one position, after a fully accepted round)
        first catch up with masked feed steps. Returns ``(draft_toks [B, k]
        int64, {slot: draft_probs [k, vocab]} for sampled lanes)``."""
        b = self.max_batch
        while True:
            lag = [s for s in active if s.draft_ctx < s.ctx]
            if not lag:
                break
            tokens = np.zeros(b, np.int64)
            positions = np.zeros(b, np.int32)
            mask = np.zeros(b, bool)
            ctx_after = np.zeros(b, np.int32)
            for s in lag:
                tokens[s.slot] = s.history[s.draft_ctx]
                positions[s.slot] = s.draft_ctx
                mask[s.slot] = True
                ctx_after[s.slot] = s.draft_ctx + 1
            _, self._draft_k, self._draft_v = self.draft.decode(
                tokens, positions, mask, ctx_after, self._tables,
                self._draft_k, self._draft_v)
            for s in lag:
                s.draft_ctx += 1
        draft_toks = np.zeros((b, k), np.int64)
        draft_probs: Dict[int, np.ndarray] = {}
        feed = np.zeros(b, np.int64)
        for s in active:
            feed[s.slot] = s.last_token
        for j in range(k):
            positions = np.zeros(b, np.int32)
            mask = np.zeros(b, bool)
            ctx_after = np.zeros(b, np.int32)
            for s in active:
                positions[s.slot] = s.draft_ctx
                mask[s.slot] = True
                ctx_after[s.slot] = s.draft_ctx + 1
            logits, self._draft_k, self._draft_v = self.draft.decode(
                feed, positions, mask, ctx_after, self._tables,
                self._draft_k, self._draft_v)
            logits = logits.float().cpu().numpy()
            for s in active:
                row = logits[s.slot]
                if s.req.temperature > 0.0:
                    p = softmax(row, s.req.temperature)
                    probs = draft_probs.setdefault(
                        s.slot, np.zeros((k, row.shape[-1])))
                    probs[j] = p
                    tok = _sample(p, s.req.rng.random_sample())
                else:
                    tok = int(row.argmax())
                draft_toks[s.slot, j] = tok
                feed[s.slot] = tok
                s.draft_ctx += 1
        return draft_toks, draft_probs

    # ---- shared harvest: sample, stream, evict ----
    def _sample_and_emit(self, seqs: List[_ActiveSeq], logits: np.ndarray):
        temps = np.array([s.req.temperature for s in seqs], np.float64)
        uniforms = np.array([s.req.rng.random_sample() for s in seqs])
        toks = sample_next_tokens(logits, temps, uniforms=uniforms)
        self._emit_batch(seqs, [[int(t)] for t in toks])

    def _emit_batch(self, seqs: List[_ActiveSeq],
                    toks_lists: List[List[int]]):
        """Stream each sequence's new tokens (one from a prefill or decode
        step, up to spec_k + 1 from a verify step), then run the finish
        checks. Callers updated ``seq.ctx`` first."""
        now = time.monotonic()
        inter = []
        self.metrics.observe_tokens(sum(len(t) for t in toks_lists))
        with self._lock:
            for seq, toks in zip(seqs, toks_lists):
                for tok in toks:
                    tok = int(tok)
                    seq.last_token = tok
                    seq.history.append(tok)
                    seq.n_generated += 1
                    if seq.n_generated == 1:
                        if seq.req.n_done:
                            # a parked stream came back: count the resume,
                            # not a TTFT (its first token came before)
                            self.metrics.count("resumed")
                        else:
                            self.metrics.observe_ttft(
                                (now - seq.req.submit_t) * 1e3)
                    else:
                        inter.append((now - seq.last_emit_t) * 1e3)
                    seq.last_emit_t = now
                    seq.req.future._emit(tok)
                if not toks:
                    continue
                if seq.req.future._cancel_requested:
                    seq.req.future._finish("cancelled")
                    self._release(seq, "cancelled")
                    self._trace_finish([seq], "ok", finish_reason="cancelled")
                elif self.eos_token_id is not None and \
                        int(toks[-1]) == self.eos_token_id:
                    seq.req.future._finish("eos")
                    self._release(seq, "completed")
                    self._trace_finish([seq], "ok", finish_reason="eos")
                elif seq.n_generated >= seq.req.max_new or \
                        seq.ctx + 1 > seq.max_total:
                    # ctx + 1: one more token would need a cache slot past
                    # this sequence's reservation
                    seq.req.future._finish("length")
                    self._release(seq, "completed")
                    self._trace_finish([seq], "ok", finish_reason="length")
        if inter:
            self.metrics.observe_inter_token(inter)

    def _release(self, seq: _ActiveSeq, event: str):
        """Evict one sequence: drop its page references, free the slot
        (lock held). A COMPLETED sequence first publishes its full pages —
        prompt AND generated tokens — into the prefix index, so they stay
        cached (refcount 1, index-held) instead of returning to the free
        list; everything else frees as refcounts reach zero."""
        if self._slots[seq.slot] is not seq:
            return
        if event == "completed" and self.prefix is not None \
                and seq.published:
            # history[:ctx] are the positions whose K/V is in the pool (the
            # last emitted token was never written); under speculation, cap
            # at what the DRAFT pools also hold, so shared pages are valid
            # in both
            n_ok = seq.ctx if self.draft is None \
                else min(seq.ctx, seq.draft_ctx)
            self.prefix.publish(seq.history, seq.pages, n_tokens=n_ok)
        self._slots[seq.slot] = None
        self._tables[seq.slot, :] = 0
        freed = self.kv.release(seq.pages)
        self.metrics.observe_evictions(freed)
        self.metrics.count(event)
        self.metrics.set_kv_pages(self.kv.used_pages, self.kv.free_pages)
        self._lock.notify_all()
