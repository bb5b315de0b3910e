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
2. **prefill**: admitted prompts run one forward per (pow2 rows, sequence
   bucket) group, writing the prompt K/V into their pages; the first token
   is sampled from the last position.
3. **decode**: one fixed-shape step for every live lane; sampling on the
   host (vectorized, per-request RNG); tokens stream out through each
   request's ``StreamingFuture``.
4. **evict**: eos / length / cancelled / hard-deadline sequences release
   their pages at once.

Backpressure: a bounded queue raising ``QueueFullError``,
``ServerClosedError`` after shutdown, and a fault barrier that fails only
the affected requests, never the worker.

Not in this slice (ROADMAP): the prefix cache (``prefix_cache=True``
raises), speculative decoding (``draft_model`` raises), the multi-tenant
scheduler, tensor-parallel meshes, telemetry, tracing and warmup manifests.
``metrics_snapshot()`` returns a plain dict.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...framework.device import resolve_device
from ...framework.flags import flag_value
from ...ops.paged_attention import kv_pool_bytes, resolve_kv_dtype
from ..bucketing import ShapeBucketPolicy
from ..request import (DeadlineExceededError, QueueFullError,
                       ServerClosedError)
from .kv_cache import PagedKVCache
from .model_fns import CachedDecoder
from .sampling import sample_next_tokens

__all__ = ["GenerationServer", "StreamingFuture", "DecodeMetrics"]


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
        available."""
        with self._cond:
            if self._done:
                return False
            self._cancel_requested = True
            return True

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
                 "submit_t", "deadline", "hard_deadline")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 seed: Optional[int], timeout_ms: Optional[float],
                 deadline_ms: Optional[float] = None):
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

    def expired(self, now: float) -> bool:
        if self.deadline is not None and now > self.deadline:
            return True
        return self.hard_expired(now)

    def hard_expired(self, now: float) -> bool:
        return self.hard_deadline is not None and now > self.hard_deadline


class _ActiveSeq:
    """One live lane of the in-flight decode batch."""

    __slots__ = ("req", "slot", "pages", "ctx", "max_total", "last_token",
                 "n_generated", "last_emit_t")

    def __init__(self, req: _Request, slot: int, pages: List[int],
                 max_total: int):
        self.req = req
        self.slot = slot
        self.pages = pages
        self.ctx = len(req.prompt)      # tokens whose K/V is cached
        self.max_total = max_total      # prompt + generation budget
        self.last_token = -1
        self.n_generated = 0
        self.last_emit_t = 0.0


_EVENTS = ("submitted", "completed", "rejected", "timed_out", "cancelled",
           "failed")


def _window_stats(values) -> dict:
    if not values:
        return {"count": 0}
    a = np.asarray(values, np.float64)
    return {"count": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


class DecodeMetrics:
    """Engine counters and bounded latency windows, read as one plain dict
    by :meth:`snapshot`."""

    def __init__(self, name: str, page_capacity: int, window: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self._events = {e: 0 for e in _EVENTS}
        self._tokens = 0
        self._ttft = deque(maxlen=window)
        self._inter = deque(maxlen=window)
        self._step = {s: deque(maxlen=window) for s in ("prefill", "decode")}
        self._occ_sum = 0
        self._occ_n = 0
        self._page_capacity = int(page_capacity)
        self._pages_used = 0
        self._evicted = 0
        self._pool_bytes = 0

    def count(self, event: str, n: int = 1):
        with self._lock:
            self._events[event] += n

    def observe_tokens(self, n: int):
        with self._lock:
            self._tokens += int(n)

    def observe_inter_token(self, ms_list: Sequence[float]):
        with self._lock:
            self._inter.extend(float(m) for m in ms_list)

    def observe_step(self, stage: str, ms: float):
        with self._lock:
            self._step[stage].append(float(ms))

    def observe_occupancy(self, n_active: int):
        with self._lock:
            self._occ_sum += int(n_active)
            self._occ_n += 1

    def observe_ttft(self, ms: float):
        with self._lock:
            self._ttft.append(float(ms))

    def set_kv_pages(self, used: int):
        with self._lock:
            self._pages_used = int(used)

    def observe_evictions(self, n_pages: int):
        with self._lock:
            self._evicted += int(n_pages)

    def set_kv_pool_bytes(self, nbytes: int):
        with self._lock:
            self._pool_bytes = int(nbytes)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "server": self.name,
                "counters": dict(self._events),
                "tokens_total": self._tokens,
                "ttft_ms": _window_stats(self._ttft),
                "inter_token_ms": _window_stats(self._inter),
                "step_ms": {s: _window_stats(w)
                            for s, w in self._step.items()},
                "batch_occupancy": {
                    "mean": (self._occ_sum / self._occ_n
                             if self._occ_n else 0.0),
                    "steps": self._occ_n},
                "kv_pages": {"capacity": self._page_capacity,
                             "used": self._pages_used,
                             "free": self._page_capacity - self._pages_used,
                             "evicted_total": self._evicted,
                             "pool_bytes": self._pool_bytes},
            }


class GenerationServer:
    """Continuous-batching decode engine over one cache-capable causal LM
    (``GPTForCausalLM``).

    ``submit_generate(prompt, ...) -> StreamingFuture`` with bounded-queue
    backpressure and scheduling deadlines; knobs default to the
    ``FLAGS_decode_*`` flags (framework/flags.py). ``device`` (default: the
    CUDA device; ``"cpu"`` must be asked for) must be the model's. The
    model is put in eval mode.
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
                 name: str = "generate",
                 prefix_cache: bool = False,
                 draft_model=None,
                 device=None,
                 start: bool = True):
        if prefix_cache:
            raise NotImplementedError(
                "the shared-prefix KV cache is not ported yet (ROADMAP "
                "queue 1: prefix cache, speculative decoding and verify)")
        if draft_model is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP queue 1: "
                "prefix cache, speculative decoding and verify)")
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
        model_dtype = str(model.dtype).replace("torch.", "")
        f32_tok = kv_pool_bytes(1, 1, nh, hd, None)
        cur_tok = kv_pool_bytes(1, 1, nh, hd, self.kv_dtype or model_dtype)
        # sub-f32 pools grant 2x pages for the same budget, as the
        # reference's auto sizing
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
            max_positions=self.max_seq_len, device=self.device)
        self.kv = PagedKVCache(model, num_pages=int(num_pages),
                               page_size=self.page_size, dtype=pool_dtype)
        self.metrics = DecodeMetrics(name, self.kv.capacity)
        self.metrics.set_kv_pool_bytes(self.kv.pool_bytes())
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
        if start:
            self.start()

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
                        deadline_ms: Optional[float] = None
                        ) -> StreamingFuture:
        """Enqueue one prompt; returns the token stream. ``timeout_ms`` is a
        SCHEDULING deadline: a request still queued past it fails with
        DeadlineExceededError; once prefilled, the stream runs to
        completion. ``deadline_ms`` is the HARD end-to-end budget: a stream
        still decoding past it is evicted at the next batch re-form. Raises
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
        req = _Request(prompt, max_new_tokens, temperature, seed,
                       timeout_ms if timeout_ms is not None
                       else self.default_timeout_ms,
                       deadline_ms=deadline_ms)
        with self._lock:
            if self._closed:
                raise ServerClosedError("engine is shut down")
            if len(self._queue) >= self.queue_capacity:
                self.metrics.count("rejected")
                raise QueueFullError(
                    f"generation queue at capacity ({self.queue_capacity})")
            self._queue.append(req)
            self.metrics.count("submitted")
            self._lock.notify_all()
        return req.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 timeout_ms: Optional[float] = None,
                 seed: Optional[int] = None) -> List[int]:
        """Synchronous convenience: submit and block for the full
        generated-token list."""
        return self.submit_generate(prompt, max_new_tokens, temperature,
                                    timeout_ms, seed).result()

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
                    self._decode_iteration(active)
        finally:
            with self._lock:
                self._loop_running = False

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
                else:
                    live.append(req)
            self._queue = live
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            while self._queue and free_slots:
                req = self._queue[0]
                max_total = min(len(req.prompt) + req.max_new,
                                self.max_seq_len)
                pages = self.kv.alloc(self.kv.pages_for(max_total))
                if pages is None:
                    break       # head-of-line until pages free up
                # between taking the reservation and publishing it into
                # self._slots no failure may keep the references
                try:
                    self._queue.popleft()
                    slot = free_slots.pop(0)
                    seq = _ActiveSeq(req, slot, pages, max_total)
                    self._slots[slot] = seq
                except BaseException:
                    self.kv.release(pages)
                    raise
                self._tables[slot, :] = 0
                self._tables[slot, :len(seq.pages)] = seq.pages
                admitted.append(seq)
            if admitted:
                self.metrics.set_kv_pages(self.kv.used_pages)
        if not admitted:
            return
        # prefill OUTSIDE the lock, grouped by prompt sequence bucket
        groups: Dict[int, List[_ActiveSeq]] = {}
        for seq in admitted:
            bucket = min(self.policy.bucket_seq(len(seq.req.prompt)),
                         self.max_seq_len)
            groups.setdefault(bucket, []).append(seq)
        for bucket, seqs in groups.items():
            self._prefill_group(seqs, bucket)

    def _fail_group(self, seqs: List[_ActiveSeq], exc: BaseException):
        with self._lock:
            for seq in seqs:
                seq.req.future._fail(exc)
                self._release(seq, "failed")

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
        t0 = time.perf_counter()
        try:
            last, k2, v2 = self.decoder.prefill(ids, lens, tables, self.kv.k,
                                                self.kv.v)
            logits = last.float().cpu().numpy()
            self.kv.k, self.kv.v = k2, v2
        except Exception as e:  # noqa: BLE001 - fault barrier: fail only
            self._fail_group(seqs, e)   # THIS group; the worker survives
            return
        self.metrics.observe_step("prefill", (time.perf_counter() - t0) * 1e3)
        self._sample_and_emit(seqs, logits[:rows])

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
        self._steps += 1
        self.metrics.observe_step("decode", (time.perf_counter() - t0) * 1e3)
        self.metrics.observe_occupancy(len(active))
        for seq in active:
            seq.ctx += 1
        self._sample_and_emit(active, logits[[s.slot for s in active]])

    # ---- shared harvest: sample, stream, evict ----
    def _sample_and_emit(self, seqs: List[_ActiveSeq], logits: np.ndarray):
        temps = np.array([s.req.temperature for s in seqs], np.float64)
        uniforms = np.array([s.req.rng.random_sample() for s in seqs])
        toks = sample_next_tokens(logits, temps, uniforms=uniforms)
        now = time.monotonic()
        inter = []
        self.metrics.observe_tokens(len(seqs))
        with self._lock:
            for seq, tok in zip(seqs, toks):
                tok = int(tok)
                seq.last_token = tok
                seq.n_generated += 1
                if seq.n_generated == 1:
                    self.metrics.observe_ttft(
                        (now - seq.req.submit_t) * 1e3)
                else:
                    inter.append((now - seq.last_emit_t) * 1e3)
                seq.last_emit_t = now
                seq.req.future._emit(tok)
                if seq.req.future._cancel_requested:
                    seq.req.future._finish("cancelled")
                    self._release(seq, "cancelled")
                elif self.eos_token_id is not None and \
                        tok == self.eos_token_id:
                    seq.req.future._finish("eos")
                    self._release(seq, "completed")
                elif seq.n_generated >= seq.req.max_new or \
                        seq.ctx + 1 > seq.max_total:
                    # ctx + 1: one more token would need a cache slot past
                    # this sequence's reservation
                    seq.req.future._finish("length")
                    self._release(seq, "completed")
        if inter:
            self.metrics.observe_inter_token(inter)

    def _release(self, seq: _ActiveSeq, event: str):
        """Evict one sequence: drop its page references, free the slot
        (lock held)."""
        if self._slots[seq.slot] is not seq:
            return
        self._slots[seq.slot] = None
        self._tables[seq.slot, :] = 0
        freed = self.kv.release(seq.pages)
        self.metrics.observe_evictions(freed)
        self.metrics.count(event)
        self.metrics.set_kv_pages(self.kv.used_pages)
        self._lock.notify_all()
