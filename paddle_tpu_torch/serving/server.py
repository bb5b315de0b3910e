"""InferenceServer: request-level dynamic-batching serving loop (the port of
``paddle_tpu/serving/server.py``).

Owns an ``inference.Predictor`` and turns its one-shot ``run`` into a
request-level service: callers ``submit`` per-request feeds and get a
Future; a worker thread drains the bounded queue and coalesces
shape-compatible requests into one padded batch (``bucketing.py``).
Execution is a three-stage pipeline:

1. **host assembly** (worker thread): requests are copied into persistent
   staging buffers, a ring per ``(signature, padded_rows)``; on the card
   they are pinned host tensors, so the copy to the device does not block;
2. **device stage** (worker thread): ``Predictor.dispatch_many`` copies the
   batch to the device without blocking, runs the program on the
   Predictor's CUDA stream, enqueues the outputs' copy into pinned host
   tensors and records a CUDA event, and returns before the card finishes;
3. **completion** (a thread of its own): waits on the batch's event,
   slices the host outputs per request, unpads and resolves each Future.

The worker hands dispatched batches to the completion thread over a
bounded queue (``FLAGS_serving_pipeline_depth`` deep), so batch N+1's
assembly and launches overlap batch N's device work while backpressure,
deadlines and the fault barrier still hold. The queue is FIFO and drained
serially, so responses keep their order (``pipeline_depth=0`` runs each
batch synchronously). Only the worker thread launches work, on the
Predictor's stream: PyTorch's current stream is per thread, and the
kernels launch on the current one (``ops/cuda_attention.py``). A staging
slot is rewritten only after the event recorded behind its host-to-device
copy has fired.

``scheduler=`` (a ``scheduling.AdmissionController``) debits each
request's tenant by its rows at ``submit`` (the typed
``QuotaExceededError`` when the tenant's bucket is empty) and hands a
window that closes without a full batch to the tenant with the lowest
virtual finish tag. ``telemetry_port=`` (or ``FLAGS_serving_telemetry_port``)
attaches the process-wide telemetry endpoint and registers this server's
``serving:<name>`` health and readiness checks; a traced request's latency
is also its latency bucket's exemplar.

The warmup manifest (reference ``:192-254, 524-560``): with
``FLAGS_compile_cache_dir`` set, the server keeps a ``WarmupManifest``
for its (name, ``Predictor.artifact_fingerprint``) pair under the cache
directory, and each padded batch signature that TRAFFIC first dispatches
(not a warmup's) is written through to it. ``warmup_from_manifest()``
replays the recorded signatures before traffic (each one a compile-cache
hit on a warm directory) and returns the count run for the first time;
with ``FLAGS_serving_warmup_from_manifest`` on, the constructor replays a
non-empty manifest itself. Servers of one name and program share a
manifest, as the workers of a fleet given one ``--name`` do.

A tensor-parallel replica is its predictor's business, as the reference's:
``Predictor.attach_serving_mesh`` (the fleet worker attaches
``FLAGS_serving_mesh_mp``'s mesh); the server reads no mesh flag.

Left out, raising ``NotImplementedError`` that names its ROADMAP queue 1
item: C-ABI batching (``FLAGS_serving_capi_batching``) (item 5d).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..observability import tracing
from ..profiler import RecordEvent
from . import metrics as metrics_mod
from .batcher import DynamicBatcher
from .bucketing import BucketSpec, ShapeBucketPolicy
from .request import QueueFullError, Request, ServerClosedError

__all__ = ["InferenceServer"]

FeedLike = Union[Dict[str, np.ndarray], Sequence[np.ndarray]]


def _flag(name):
    from ..framework.flags import flag_value
    return flag_value(name)


class _Slot:
    """One set of staging buffers: host tensors (pinned when ``pin``),
    numpy views of them that assembly writes, and the event recorded behind
    the last host-to-device copy that read them."""

    __slots__ = ("tensors", "arrays", "event")

    def __init__(self, feed_shapes, pin: bool):
        self.tensors = [torch.zeros(s, dtype=torch.from_numpy(
            np.zeros((), d)).dtype, pin_memory=pin) for s, d in feed_shapes]
        self.arrays = [t.numpy() for t in self.tensors]
        self.event = None


class _StagingPool:
    """Persistent host staging buffers, a ring per ``(signature,
    padded_rows)`` key.

    Assembly writes each batch into the next ring slot instead of
    allocating fresh arrays. The ring holds ``pipeline_depth + 2`` slots,
    as the reference's; a slot whose last host-to-device copy may still be
    running is waited for (its event) before it is handed out again."""

    def __init__(self, slots: int, pin: bool):
        self._slots = max(2, int(slots))
        self._pin = pin
        self._rings: Dict[Tuple, Tuple[list, list]] = {}

    def __len__(self):
        return len(self._rings)

    def acquire(self, key: Tuple, feed_shapes) -> _Slot:
        """Next slot for ``key``; ``feed_shapes`` is ``[(shape, dtype),
        ...]``, used only on first allocation."""
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = (
                [_Slot(feed_shapes, self._pin) for _ in range(self._slots)],
                [0])
        slots, idx = ring
        slot = slots[idx[0]]
        idx[0] = (idx[0] + 1) % self._slots
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        return slot


class _Inflight:
    """A dispatched-but-unfetched batch riding the completion queue.
    ``traced`` holds the batch's trace-carrying requests (usually
    empty) so the completion stage knows to emit device_wait/fetch
    spans into their traces."""

    __slots__ = ("batch", "pending", "rows", "padded_rows",
                 "assembly_ms", "dispatch_ms", "record_latency",
                 "record_traffic", "traced")

    def __init__(self, batch, pending, rows, padded_rows, assembly_ms,
                 dispatch_ms, record_latency, record_traffic,
                 traced=()):
        self.batch = batch
        self.pending = pending
        self.rows = rows
        self.padded_rows = padded_rows
        self.assembly_ms = assembly_ms
        self.dispatch_ms = dispatch_ms
        self.record_latency = record_latency
        self.record_traffic = record_traffic
        self.traced = traced


class InferenceServer:
    """Dynamic-batching server over one Predictor.

    Parameters default to the ``FLAGS_serving_*`` knobs
    (framework/flags.py) so a deployment can be tuned without code
    changes. ``seq_buckets``/``seq_axis`` opt into sequence-length
    bucketing (see ShapeBucketPolicy for the independence assumption);
    batch-row padding to powers of two is on by default and can be
    disabled with ``pad_batch=False``. ``pipeline_depth`` bounds how
    many dispatched batches may await completion (0 = synchronous
    execute); ``donate_inputs`` is accepted and has no effect
    (``FLAGS_serving_donate_inputs``: torch has no donation).

    ``start=False`` defers the worker thread: requests queue up until
    ``start()`` (or ``serve_forever``) — useful for tests and for
    pre-loading a queue before measuring.
    """

    def __init__(self, predictor, *, max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None,
                 default_timeout_ms: Optional[float] = None,
                 pad_batch: Optional[bool] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_axis: int = 1, name: str = "default",
                 pipeline_depth: Optional[int] = None,
                 donate_inputs: Optional[bool] = None,
                 telemetry_port: Optional[int] = None,
                 ready_requires_warmup: Optional[bool] = None,
                 scheduler=None, start: bool = True):
        if _flag("FLAGS_serving_capi_batching"):
            raise NotImplementedError(
                "batching C-ABI predictors (FLAGS_serving_capi_batching) "
                "waits for the C ABI, ROADMAP queue 1 item 5d")
        self.predictor = predictor
        self.max_batch_size = int(max_batch_size if max_batch_size
                                  is not None
                                  else _flag("FLAGS_serving_max_batch_size"))
        self.max_wait_ms = float(max_wait_ms if max_wait_ms is not None
                                 else _flag("FLAGS_serving_max_wait_ms"))
        cap = queue_capacity if queue_capacity is not None \
            else _flag("FLAGS_serving_queue_capacity")
        self.default_timeout_ms = default_timeout_ms \
            if default_timeout_ms is not None \
            else (_flag("FLAGS_serving_default_timeout_ms") or None)
        if pad_batch is None:
            pad_batch = bool(_flag("FLAGS_serving_pad_batch_pow2"))
        self.pipeline_depth = max(0, int(
            pipeline_depth if pipeline_depth is not None
            else _flag("FLAGS_serving_pipeline_depth")))
        self._donate = bool(donate_inputs if donate_inputs is not None
                            else _flag("FLAGS_serving_donate_inputs"))
        self.policy = ShapeBucketPolicy(
            max_batch_size=self.max_batch_size, pad_batch=pad_batch,
            seq_buckets=seq_buckets, seq_axis=seq_axis)
        self.metrics = metrics_mod.register(metrics_mod.ServingMetrics(
            name, window=int(_flag("FLAGS_serving_latency_window"))))
        self.scheduler = scheduler  # scheduling.AdmissionController
        if scheduler is not None:
            from .scheduling.schedz import register_controller
            register_controller(scheduler)
        self._batcher = DynamicBatcher(
            max_batch_size=self.max_batch_size,
            max_wait_ms=self.max_wait_ms, capacity=int(cap),
            metrics=self.metrics, scheduler=scheduler)
        self._feed_names = list(predictor.get_input_names())
        self._staging = _StagingPool(
            self.pipeline_depth + 2,
            pin=torch.device(predictor.device).type == "cuda")
        self._completion_q: "queue.Queue[Optional[_Inflight]]" = \
            queue.Queue(maxsize=max(1, self.pipeline_depth))
        self._completion_thread: Optional[threading.Thread] = None
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self._loop_running = False      # a thread is inside _loop
        self._compiled = set()          # signatures already executed
        self._manifest_recorded = set()  # signatures already persisted
        self._lock = threading.Lock()
        # readiness (distinct from liveness): with the gate on, the
        # server reports not-ready until a warmup pass completes, so a
        # fleet router never routes traffic to a cold replica that
        # would compile on the request path
        self._ready_gate = bool(
            ready_requires_warmup if ready_requires_warmup is not None
            else _flag("FLAGS_serving_ready_requires_warmup"))
        self._warmed = threading.Event()
        self.telemetry = self._attach_telemetry(telemetry_port)
        self._manifest = self._init_manifest(self.metrics.name)
        if self._manifest is not None and len(self._manifest) and \
                bool(_flag("FLAGS_serving_warmup_from_manifest")):
            # restart fast path: replay exactly the signatures the
            # previous process's traffic dispatched
            self.warmup_from_manifest()
        if start:
            self.start()

    def _init_manifest(self, name: str):
        """Warmup manifest for this (``name``, model) pair under the
        compile-cache directory; None when the cache is disabled or the
        predictor has no stable artifact identity."""
        if not str(_flag("FLAGS_compile_cache_dir") or ""):
            return None
        try:
            from ..compile_cache import WarmupManifest, default_cache
            cache = default_cache()
            fp_fn = getattr(self.predictor, "artifact_fingerprint", None)
            fp = fp_fn() if callable(fp_fn) else None
            if cache is None or fp is None:
                return None
            return WarmupManifest(WarmupManifest.default_path(
                cache.directory, name, fp))
        except Exception:  # noqa: BLE001 - the manifest is an
            return None    # optimization artifact, never a hard dep

    def _attach_telemetry(self, telemetry_port: Optional[int]):
        """Attach the shared telemetry endpoint. Port -1 = off (the flag
        default), 0 = ephemeral, >0 = fixed; a port that cannot be bound
        raises ``OSError``. The endpoint is process-wide and outlives this
        server (the registry it exposes aggregates every subsystem), so
        shutdown() deregisters only this server's checks."""
        port = telemetry_port if telemetry_port is not None \
            else _flag("FLAGS_serving_telemetry_port")
        if port is None or int(port) < 0:
            return None
        from .. import observability
        srv = observability.start_telemetry_server(port=int(port))
        observability.add_health_check(
            f"serving:{self.metrics.name}", self._health)
        observability.add_readiness_check(
            f"serving:{self.metrics.name}", self._readiness)
        return srv

    def _health(self):
        """Healthy while accepting traffic: not shut down, and if the
        worker was ever started it must still be alive."""
        if self._closed:
            return False, "shut down"
        w = self._worker
        if w is not None and not w.is_alive() and not self._loop_running:
            return False, "worker thread died"
        return True, {"queue_depth": self.queue_depth,
                      "inflight_batches": self.inflight_batches}

    def _readiness(self):
        return self.ready, {"warmed": self._warmed.is_set(),
                            "gated": self._ready_gate}

    @property
    def warmup_manifest(self):
        """The live WarmupManifest (or None): traffic-dispatched batch
        signatures, written through to disk as they first appear."""
        return self._manifest

    # ------------------------------------------------------ readiness
    @property
    def ready(self) -> bool:
        """True when this server should be handed traffic. Without the
        warmup gate (``FLAGS_serving_ready_requires_warmup`` /
        ``ready_requires_warmup=``) any live server is ready; with it,
        readiness additionally requires a completed ``warmup()`` /
        ``warmup_from_manifest()`` (or explicit ``mark_ready()``)."""
        if self._closed:
            return False
        return self._warmed.is_set() or not self._ready_gate

    def mark_ready(self):
        """Flip readiness on without a warmup pass (a deployment that
        accepts compiling on the request path)."""
        self._warmed.set()

    # ------------------------------------------------------ lifecycle
    def start(self):
        with self._lock:
            if self._closed:
                raise ServerClosedError("server already shut down")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._loop, name=f"serving-{self.metrics.name}",
                    daemon=True)
                self._worker.start()
        return self

    def serve_forever(self):
        """Run the batching loop in the CALLING thread until
        ``shutdown`` (from another thread) — the synchronous deployment
        mode, mirroring the reference C++ serving hosts that own the
        loop themselves. (The completion stage still runs on its own
        thread when ``pipeline_depth > 0``.)"""
        with self._lock:
            if self._closed:
                raise ServerClosedError("server already shut down")
            if self._worker is not None and self._worker.is_alive():
                raise RuntimeError(
                    "worker thread already running; serve_forever is the "
                    "no-thread mode (construct with start=False)")
        self._loop()

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests; with ``drain`` (default) finish
        everything already queued AND in flight in the pipeline,
        otherwise fail still-queued futures with ServerClosedError
        (already-dispatched batches complete either way). Idempotent."""
        with self._lock:
            self._closed = True
        if not drain:
            self._batcher.cancel_pending(
                ServerClosedError("server shut down before this request "
                                  "was scheduled"))
        self._batcher.stop()      # worker exits once the queue is empty
        w = self._worker
        if w is not None and w.is_alive() and \
                w is not threading.current_thread():
            w.join(timeout)
        elif drain and not self._loop_running:
            # never-started server (start=False): drain inline so
            # queued futures still resolve; a live serve_forever loop
            # drains itself (stop() above lets it exit once empty)
            self._loop()
        else:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while drain and self._loop_running and \
                    (deadline is None or time.monotonic() < deadline):
                time.sleep(0.005)  # wait out a serve_forever drain
        self._stop_completion(timeout)
        if self.telemetry is not None:
            from ..observability import (remove_health_check,
                                         remove_readiness_check)
            remove_health_check(f"serving:{self.metrics.name}")
            remove_readiness_check(f"serving:{self.metrics.name}")
        metrics_mod.unregister(self.metrics.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
        return False

    # ------------------------------------------------------ submission
    def _normalize(self, feed: FeedLike) -> List[np.ndarray]:
        if isinstance(feed, dict):
            missing = [n for n in self._feed_names if n not in feed]
            if missing:
                raise KeyError(f"feed missing inputs {missing}")
            arrs = [np.asarray(feed[n]) for n in self._feed_names]
        else:
            arrs = [a if type(a) is np.ndarray else np.asarray(a)
                    for a in feed]
            if len(arrs) != len(self._feed_names):
                raise ValueError(
                    f"expected {len(self._feed_names)} feeds "
                    f"({self._feed_names}), got {len(arrs)}")
        return arrs

    def submit(self, feed: FeedLike,
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        """Enqueue one request; returns a Future resolving to the list
        of output arrays for THIS request (padded rows/positions already
        sliced away). Raises QueueFullError at capacity and
        ServerClosedError after shutdown; with a ``scheduler``, the
        typed per-tenant ``QuotaExceededError`` (a QueueFullError) when
        ``tenant``'s quota is spent."""
        if self._closed:
            raise ServerClosedError("server is shut down")
        req = self._make_request(feed, timeout_ms,
                                 trace=tracing.request_context(),
                                 tenant=tenant)
        self.metrics.count("submitted")
        try:
            self._batcher.put(req)
        except QueueFullError:
            self.metrics.count("rejected")
            self._trace_shed([req])
            raise
        return req.future

    def _trace_shed(self, reqs: Sequence[Request]):
        """Tail-promote shed requests: a QueueFullError is the kind of
        tail event an unsampled trace must still record."""
        now = time.time_ns()
        for r in reqs:
            if r.trace is not None:
                tracing.record_span(
                    r.trace, "serving::shed", stage="shed",
                    start_unix_ns=now, duration_ms=0.0,
                    status="error",
                    attrs={"server": self.metrics.name,
                           "error": "QueueFullError"}, root=True)

    def _make_request(self, feed: FeedLike,
                      timeout_ms: Optional[float],
                      trace=None,
                      tenant: Optional[str] = None) -> Request:
        arrs = self._normalize(feed)
        rows = int(arrs[0].shape[0]) if arrs[0].ndim else 1
        if rows > self.max_batch_size:
            raise ValueError(
                f"request carries {rows} rows > max_batch_size="
                f"{self.max_batch_size}; split it or raise the cap")
        orig_seq = None
        if self.policy.seq_buckets is not None:
            ax = self.policy.seq_axis
            orig_seq = [int(a.shape[ax]) if a.ndim > ax else -1
                        for a in arrs]
            arrs = self.policy.pad_request_seq(arrs)
        # the request's trace context gets a child identity: that
        # child's span id IS the serving::request span, and the stage
        # spans (queue/assembly/...) parent under it
        return Request(arrs, rows, self.policy.signature(arrs),
                       orig_seq=orig_seq,
                       timeout_ms=timeout_ms if timeout_ms is not None
                       else self.default_timeout_ms,
                       trace=trace.child() if trace is not None
                       else None,
                       tenant=tenant)

    def submit_many(self, feeds: Sequence[FeedLike],
                    timeout_ms: Optional[float] = None,
                    trace_contexts: Optional[Sequence] = None):
        """Bulk ``submit``: requests are validated up front and
        enqueued with one batcher lock acquisition and metrics update.
        All-or-nothing on capacity: raises QueueFullError without
        enqueueing any of the batch. ``trace_contexts`` (one per feed, None
        entries allowed) carries propagated trace identities; without it
        each request picks up the ambient context like
        ``submit``."""
        if self._closed:
            raise ServerClosedError("server is shut down")
        if trace_contexts is None:
            reqs = [self._make_request(f, timeout_ms,
                                       trace=tracing.request_context())
                    for f in feeds]
        else:
            reqs = [self._make_request(f, timeout_ms, trace=ctx)
                    for f, ctx in zip(feeds, trace_contexts)]
        self.metrics.count("submitted", len(reqs))
        try:
            self._batcher.put_many(reqs)
        except QueueFullError:
            self.metrics.count("rejected", len(reqs))
            self._trace_shed(reqs)
            raise
        return [r.future for r in reqs]

    # ------------------------------------------------------- warmup
    def bucket_specs(self) -> List[BucketSpec]:
        """The full bucket lattice traffic can land on: power-of-two
        batch buckets up to max_batch_size crossed with the configured
        seq buckets. (With ``pad_batch=False`` every row count is its own
        shape; only the max-batch point is returned.)"""
        if self.policy.pad_batch:
            batches, b = [], 1
            while b < self.max_batch_size:
                batches.append(b)
                b <<= 1
            batches.append(self.max_batch_size)
        else:
            batches = [self.max_batch_size]
        seqs = self.policy.seq_buckets or [None]
        return [BucketSpec(b, s) for b in batches for s in seqs]

    def warmup(self, bucket_specs: Optional[Sequence] = None) -> int:
        """Run the bucket lattice once before traffic: for each spec (a
        BucketSpec, an int batch bucket, or a (batch, seq) tuple) one zero
        batch through the predictor; defaults to the full
        ``bucket_specs()`` lattice. On the card a shape's first run pays
        the kernels' first launches, the caching allocator's growth and
        cuBLAS's choices, which the reference's XLA compile stood for.
        Returns the number of signatures run for the first time (the
        ``compile_cache`` misses). Warmup batches count in the
        compile-cache metric but not in the traffic metrics."""
        if bucket_specs is None:
            bucket_specs = self.bucket_specs()
        specs = []
        for s in bucket_specs:
            if isinstance(s, BucketSpec):
                specs.append(s)
            elif isinstance(s, (tuple, list)):
                specs.append(BucketSpec(*s))
            else:
                specs.append(BucketSpec(int(s)))
        feed_specs = getattr(self.predictor, "_artifact").feeds
        fresh = 0
        for spec in specs:
            arrs = []
            for fs in feed_specs:
                shape = [d if d not in (None, -1) else 1
                         for d in fs["shape"]]
                shape[0] = spec.batch
                ax = self.policy.seq_axis
                if spec.seq is not None and len(shape) > ax:
                    shape[ax] = spec.seq
                arrs.append(np.zeros(tuple(shape), fs["dtype"]))
            sig = self.policy.signature(arrs)
            req = Request(arrs, spec.batch, sig)
            fresh += self._execute([req], record_latency=False,
                                   record_traffic=False)
            req.future.result()    # surface warmup failures loudly
        self._warmed.set()
        return fresh

    def warmup_from_manifest(self, path: Optional[str] = None) -> int:
        """Replay the persisted warmup manifest: run exactly the padded
        batch signatures a previous process's traffic dispatched (each
        one a compile-cache hit on a warm directory) instead of the full
        lattice. Returns the count run for the first time, as
        ``warmup``; 0 when no manifest exists. Signatures recorded under
        a larger ``max_batch_size`` than this server's are skipped."""
        if path is not None:
            from ..compile_cache import WarmupManifest
            manifest = WarmupManifest(path)
        else:
            manifest = self._manifest
        if manifest is None:
            return 0
        fresh = 0
        # only the batch-predict signatures: decode-engine entries
        # ("generate_*" sites) are replayed by GenerationServer
        for spec in manifest.specs(site="predict"):
            arrs = [np.zeros(tuple(shape), dtype)
                    for shape, dtype in spec["feeds"]]
            rows = int(arrs[0].shape[0]) if arrs[0].ndim else 1
            if rows > self.max_batch_size:
                continue
            req = Request(arrs, rows, self.policy.signature(arrs))
            fresh += self._execute([req], record_latency=False,
                                   record_traffic=False)
            req.future.result()    # surface replay failures loudly
        self._warmed.set()
        return fresh

    # ------------------------------------------------------ execution
    def _loop(self):
        with self._lock:
            self._loop_running = True
        pipelined = self.pipeline_depth > 0
        try:
            while True:
                batch = self._batcher.next_batch()
                if batch is None:
                    return
                if pipelined:
                    inflight, _ = self._dispatch(batch)
                    if inflight is not None:
                        self._ensure_completion_thread()
                        # bounded hand-off: blocks at pipeline_depth
                        # outstanding batches (backpressure propagates
                        # to the request queue, then QueueFullError)
                        self._completion_q.put(inflight)
                else:
                    self._execute(batch)
        finally:
            if pipelined:
                self._drain_pipeline()
            with self._lock:
                self._loop_running = False

    # ---- stage 1: host assembly (staging pool) ----
    def _assemble(self, batch: List[Request], sig, padded_rows: int
                  ) -> _Slot:
        """Copy the batch's feeds into the persistent staging buffers
        for ``(sig, padded_rows)``, zeroing the pad rows."""
        feed_shapes = [((padded_rows,) + tuple(shape), dtype)
                       for dtype, shape in sig]
        slot = self._staging.acquire((sig, padded_rows), feed_shapes)
        for i, buf in enumerate(slot.arrays):
            ofs = 0
            for r in batch:
                buf[ofs:ofs + r.rows] = r.feeds[i]
                ofs += r.rows
            if ofs < padded_rows:
                buf[ofs:] = 0
        return slot

    # ---- stage 2: transfer + async device dispatch ----
    def _dispatch(self, batch: List[Request], record_latency: bool = True,
                  record_traffic: bool = True):
        """Assemble + dispatch one coalesced batch without waiting for
        results. Returns ``(inflight, miss)``; inflight is None when
        dispatch itself failed (futures already resolved with the error;
        the fault barrier keeps the worker alive)."""
        rows = sum(r.rows for r in batch)
        padded_rows = self.policy.bucket_batch(rows)
        sig = batch[0].signature
        if record_traffic:
            # padding waste: real input elements vs elements the padded
            # device batch actually carries
            per_row = self.policy.elements_per_row(sig)
            real = sum(int(np.prod(a.shape)) if a.ndim else 1
                       for r in batch for a in r.feeds)
            self.metrics.observe_batch(rows, real, padded_rows * per_row)

        cache_key = (sig, padded_rows)
        miss = cache_key not in self._compiled
        self._compiled.add(cache_key)
        if record_traffic and self._manifest is not None and \
                cache_key not in self._manifest_recorded:
            # first TRAFFIC dispatch of this signature (whether or not
            # warmup ran it): persist it so a restarted server warms
            # exactly the lattice real traffic lands on
            self._manifest_recorded.add(cache_key)
            self._manifest.record(
                [((padded_rows,) + tuple(shape), str(np.dtype(dtype)))
                 for dtype, shape in sig])

        rows_list = [r.rows for r in batch]
        n_pad = padded_rows - rows
        if n_pad:
            # the pad block rides as a trailing pseudo-request so
            # fetch_many's slices line up; its outputs are discarded
            rows_list.append(n_pad)
        span_args = {"rows": rows, "padded": padded_rows}
        # request tracing: warmup batches (record_traffic=False) carry
        # no trace contexts by construction, so spans only ever come
        # from real traffic
        traced = [r for r in batch if r.trace is not None] \
            if record_traffic else []
        t_wall = time.time_ns() if traced else 0
        t0 = time.perf_counter()
        try:
            with RecordEvent("serving::assemble", args=span_args):
                slot = self._assemble(batch, sig, padded_rows)
            t1 = time.perf_counter()
            with RecordEvent("serving::dispatch", args=span_args):
                pending = self.predictor.dispatch_many(
                    assembled=slot.tensors, rows=rows_list,
                    donate=self._donate)
            slot.event = pending.inputs_done
        except Exception as e:  # noqa: BLE001 - fault barrier: the
            # worker thread must survive any model error and fail only
            # the requests of THIS batch
            self.metrics.observe_compile(hit=not miss, signature=cache_key)
            for r in batch:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(e)
                self.metrics.count("failed")
            self._trace_failed(traced, "dispatch", e)
            return None, int(miss)
        t2 = time.perf_counter()
        # counted on EVERY dispatch (runtime included), not just during
        # warmup — steady-state traffic shows up as a stream of hits,
        # so a dashboard can tell "compile-free" from "no data". A first
        # run whose record the compile cache supplied is a hit too.
        outcomes = getattr(self.predictor, "cache_outcomes", None) or {}
        self.metrics.observe_compile(
            hit=not miss or outcomes.get("serving") == "hit",
            signature=cache_key)
        assembly_ms = (t1 - t0) * 1e3
        dispatch_ms = (t2 - t1) * 1e3
        for r in traced:
            # queue wait = submit to batch formation; the stage spans
            # reuse the batch's measured intervals anchored on the
            # wall clock so cross-process stitching lines up
            attrs = dict(span_args, server=self.metrics.name)
            tracing.record_span(
                r.trace, "serving::queue", stage="queue",
                start_unix_ns=r.t_wall_ns,
                duration_ms=max(0.0, (t_wall - r.t_wall_ns) / 1e6),
                attrs=attrs)
            tracing.record_span(
                r.trace, "serving::assembly", stage="assembly",
                start_unix_ns=t_wall, duration_ms=assembly_ms,
                attrs=attrs)
            tracing.record_span(
                r.trace, "serving::dispatch", stage="dispatch",
                start_unix_ns=t_wall + int(assembly_ms * 1e6),
                duration_ms=dispatch_ms,
                attrs=dict(attrs, compile_miss=bool(miss)))
        return _Inflight(batch, pending, rows, padded_rows,
                         assembly_ms, dispatch_ms,
                         record_latency, record_traffic,
                         traced=traced), int(miss)

    def _trace_failed(self, traced, stage: str, exc: BaseException):
        """Error spans + tail promotion for a failed batch's traced
        requests (the fault-barrier counterpart of the happy-path
        stage spans)."""
        now = time.time_ns()
        for r in traced:
            tracing.record_span(
                r.trace, f"serving::{stage}", stage=stage,
                start_unix_ns=now, duration_ms=0.0, status="error",
                attrs={"server": self.metrics.name,
                       "error": f"{type(exc).__name__}: {exc}"},
                root=True)

    # ---- stage 3: completion (block, fetch, unpad, resolve) ----
    def _complete(self, inf: _Inflight):
        batch = inf.batch
        span = RecordEvent("serving::complete",
                           args={"rows": inf.rows,
                                 "padded": inf.padded_rows})
        t_wall = time.time_ns() if inf.traced else 0
        try:
            with span:
                t0 = time.perf_counter()
                inf.pending.block()          # the batch's CUDA event
                t1 = time.perf_counter()
                results = self.predictor.fetch_many(inf.pending)
                t2 = time.perf_counter()
                span.set_arg("device_wait_ms",
                             round((t1 - t0) * 1e3, 3))
                span.set_arg("fetch_ms", round((t2 - t1) * 1e3, 3))
        except Exception as e:  # noqa: BLE001 - fault barrier: a fetch
            # error fails THIS batch only; the completion thread and
            # any other in-flight batch keep going
            for r in batch:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(e)
                self.metrics.count("failed")
            self._trace_failed(inf.traced, "fetch", e)
            return
        for r in inf.traced:
            attrs = {"rows": inf.rows, "padded": inf.padded_rows,
                     "server": self.metrics.name}
            tracing.record_span(
                r.trace, "serving::device_wait", stage="device_wait",
                start_unix_ns=t_wall, duration_ms=(t1 - t0) * 1e3,
                attrs=attrs)
            tracing.record_span(
                r.trace, "serving::fetch", stage="fetch",
                start_unix_ns=t_wall + int((t1 - t0) * 1e9),
                duration_ms=(t2 - t1) * 1e3, attrs=attrs)
        completed = 0
        latencies = []
        for r, outs in zip(batch, results):   # padding slice (if any)
            if not r.future.set_running_or_notify_cancel():
                continue                      # cancelled between drain+run
            if r.orig_seq is not None and r.orig_seq[0] > 0:
                # outputs are unpadded against the FIRST feed's original
                # sequence length (the single-sequence-input common case)
                outs = [self.policy.unpad_output(o, r.orig_seq[0])
                        for o in outs]
            r.future.set_result(outs)
            completed += 1
            if inf.record_latency:
                latencies.append(r.latency_ms())
            if r.trace is not None:
                lat = r.latency_ms()
                tracing.record_span(
                    r.trace, "serving::request", stage="request",
                    start_unix_ns=r.t_wall_ns, duration_ms=lat,
                    attrs={"rows": r.rows,
                           "server": self.metrics.name}, root=True)
                tracing.record_exemplar("paddle_serving_latency_ms",
                                        lat, r.trace.trace_id)
        # metrics are bulked per BATCH, not per request: count/stat_add
        # take two locks each, a measurable tax at high request rates
        if inf.record_traffic and completed:
            self.metrics.count("completed", completed)
        if latencies:
            self.metrics.observe_latency_many(latencies)
        if inf.record_traffic:
            self.metrics.observe_stage_times(
                inf.assembly_ms, inf.dispatch_ms,
                (t1 - t0) * 1e3, (t2 - t1) * 1e3)

    def _execute(self, batch: List[Request], record_latency: bool = True,
                 record_traffic: bool = True) -> int:
        """Synchronous path (warmup and ``pipeline_depth=0``): dispatch
        then complete inline. Returns 1 on a compile-cache miss (a
        signature run for the first time), else 0."""
        inflight, miss = self._dispatch(batch, record_latency,
                                        record_traffic)
        if inflight is not None:
            self._complete(inflight)
        return miss

    # ---- completion thread plumbing ----
    def _ensure_completion_thread(self):
        t = self._completion_thread
        if t is None or not t.is_alive():
            self._completion_thread = t = threading.Thread(
                target=self._completion_loop,
                name=f"serving-complete-{self.metrics.name}", daemon=True)
            t.start()

    def _completion_loop(self):
        while True:
            inf = self._completion_q.get()
            try:
                if inf is None:          # shutdown sentinel
                    return
                self._complete(inf)      # has its own fault barrier
            except Exception as e:  # noqa: BLE001 - belt and braces:
                # even a bug past _complete's barrier (unpad, metrics)
                # must not kill the completion thread mid-traffic
                for r in inf.batch:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)
            finally:
                self._completion_q.task_done()

    def _drain_pipeline(self, timeout: Optional[float] = None):
        """Wait until every dispatched batch has completed (or the
        completion thread died / ``timeout`` elapsed)."""
        q = self._completion_q
        deadline = None if timeout is None else time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                t = self._completion_thread
                if t is None or not t.is_alive():
                    return
                if deadline is not None and time.monotonic() > deadline:
                    return
                q.all_tasks_done.wait(0.05)

    def _stop_completion(self, timeout: Optional[float] = None):
        t = self._completion_thread
        if t is not None and t.is_alive():
            self._completion_q.put(None)
            t.join(timeout)
        self._completion_thread = None

    # ------------------------------------------------------ inspection
    @property
    def queue_depth(self) -> int:
        return len(self._batcher)

    @property
    def inflight_batches(self) -> int:
        """Dispatched batches not yet completed (pipeline occupancy)."""
        return self._completion_q.unfinished_tasks

    def metrics_json(self, indent: Optional[int] = None) -> str:
        return self.metrics.to_json(indent=indent)
