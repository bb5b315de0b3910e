"""Replica worker (the port of ``paddle_tpu/serving/fleet/worker.py``): one
process hosting a serving backend behind HTTP.

A fleet replica is this module run as a process
(``python -m paddle_tpu_torch.serving.fleet.worker``): it builds a backend —
a real ``InferenceServer`` over a loaded ``Predictor`` (and optionally a
``GenerationServer``), or the accelerator-emulating ``StubBackend`` — binds
``ReplicaApp`` (the stdlib HTTP service over that backend), announces its
port to the supervisor through an atomically-written announce file, runs
warmup (flipping readiness), and serves until ``POST /shutdown`` or
SIGTERM. It runs on the card unless passed ``--cpu``; without a GPU and
without ``--cpu`` it exits non-zero with the device error.

Data plane (binary codec, see codec.py):

- ``POST /submit_many?timeout_ms=`` — one coalesced request batch in,
  per-request results out; whole-batch ``QueueFullError`` is HTTP 429
  (the router's shed/retry signal), per-request failures ride the
  results framing so one bad request never fails its batch peers.
- ``POST /generate`` — JSON request in, newline-delimited JSON token
  events streamed out (close-delimited body), one decode stream per
  connection.

Control plane (JSON):

- ``GET /healthz`` (liveness) / ``GET /readyz`` (readiness = warmup
  complete) / ``GET /metrics`` (this process's registry, Prometheus
  text) / ``GET /statusz`` / ``GET /tracez`` (this process's span flight
  recorder; the router's merged ``/tracez`` fans out to it) / ``GET /sloz``
  / ``GET /schedz`` (this process's admission and autoscaler state; the
  router's merged views sum them fleet-wide) / ``GET /goodputz`` (this
  process's goodput ledger and step profiler) / ``GET /execz`` (this
  process's signature registry; the router's ``/execz`` aggregates) /
  ``GET /profilez`` (the capture ring, or ``?duration_ms=`` one bounded
  capture on this replica) / ``GET /numericsz`` (this process's numerics
  plane with THIS replica's canary overlaid).
- ``POST /reload`` — hot weight swap: load the version-stamped artifact
  named in the body, warm the replacement server, swap it in, drain the
  old one and release it. The router drains this replica first, so
  in-flight requests never see the swap.
- ``POST /shutdown`` — graceful exit.

Resilience (resilience.py): the worker consumes the codec DEADLINE trailer
— a request whose budget is already exhausted when the batch arrives is
answered with ``DeadlineExceededError`` without being dispatched — and
hosts the device-wedge watchdog: backends bracket device work on a
``WedgeMonitor``; a dispatch in flight longer than
``FLAGS_fleet_wedge_timeout_ms`` flips ``/readyz`` to not-ready, fails
requests waiting on the device with the typed ``ReplicaWedgedError``, and
requests shutdown so the supervisor's respawn replaces the process.

``ThreadReplicaFactory`` runs the same app and backend on a thread in the
current process — the test double and the single-process deployment mode;
the wire protocol and routing logic are identical.

The numerics SDC canary (``arm_canary``) sweeps a deterministic checksum
every ``FLAGS_numerics_canary_period_s`` (``--canary-period-s``) and on
readiness transitions: the backend's ``canary_probe`` where it has one
(the stub), the device canary otherwise (``PredictorBackend``, on its
device). A failed sweep quarantines the replica: ``/readyz`` answers 503
with ``corrupt``, so the router's poller opens its breaker.

Warmup (``--warmup``): ``manifest`` replays the signatures the fleet's
traffic dispatched before (the servers' warmup manifests under the shared
``FLAGS_compile_cache_dir``, each one a compile-cache hit), ``lattice`` the
full bucket lattice, ``auto`` the manifest when it has entries, else the
lattice, ``none`` flips ready without running anything. A worker started
by ``main`` reports its start-up split in its ``/readyz`` body
(``startup``: seconds from the process's start to ``main``, CUDA context,
kernel library, model, warmup).

Left out, raising ``NotImplementedError`` that names its ROADMAP queue 1
item: the serving mesh (``FLAGS_serving_mesh_mp`` above 1, item 5c).
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np

from ...observability import tracing
from ..request import (DeadlineExceededError, QueueFullError,
                       QuotaExceededError, ServerClosedError)
from . import codec
from .resilience import ReplicaWedgedError, WedgeMonitor, WedgeWatchdog

__all__ = ["ReplicaApp", "PredictorBackend", "StubBackend",
           "ThreadReplicaFactory", "write_announce_file",
           "read_announce_file", "arm_wedge_watchdog", "arm_canary"]


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        v = flag_value(name)
    except KeyError:
        return default
    return v


class _ConnectionDrop(Exception):
    """Raised by a backend to simulate a replica crash from the
    peer's perspective: the handler closes the connection without a
    response (the router sees a dead socket, exactly like a killed
    process) and the backend reports unhealthy afterwards."""


def write_announce_file(path: str, port: int):
    """Atomically publish this worker's address for the supervisor
    (partial reads are impossible: tmp + rename)."""
    data = json.dumps({"pid": os.getpid(), "port": int(port),
                       "url": f"http://127.0.0.1:{int(port)}"})
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def read_announce_file(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class _WorkerMetrics:
    """Worker-process-side resilience counters on the default
    registry (the router's merged /metrics re-labels them with
    ``replica="<id>"``)."""

    def __init__(self):
        from ...observability.registry import default_registry
        reg = default_registry()
        name = tracing.process_name()
        self._deadline = reg.counter(
            "paddle_fleet_worker_deadline_rejects_total",
            "requests answered DeadlineExceededError at the worker "
            "without device dispatch (budget exhausted on arrival)",
            ("replica",)).labels(replica=name)
        self._wedges = reg.counter(
            "paddle_fleet_wedge_events_total",
            "device-wedge watchdog firings (dispatch exceeded "
            "FLAGS_fleet_wedge_timeout_ms)",
            ("replica",)).labels(replica=name)
        self._wedged = reg.gauge(
            "paddle_fleet_wedged",
            "1 after the watchdog declared this replica's device "
            "wedged (readiness stays red until restart)",
            ("replica",)).labels(replica=name)

    def count_deadline_reject(self, n: int = 1):
        self._deadline.inc(n)

    def count_wedge(self):
        self._wedges.inc()
        self._wedged.set(1)


_WM_LOCK = threading.Lock()
_WM: Optional[_WorkerMetrics] = None


def _worker_metrics() -> _WorkerMetrics:
    global _WM
    with _WM_LOCK:
        if _WM is None:
            _WM = _WorkerMetrics()
        return _WM


_WSCHED_LOCK = threading.Lock()
_WSCHED = None


def _worker_scheduler():
    """This worker process's admission controller (lazy singleton,
    registered on /schedz). Gates /submit_many per-tenant at cost 1
    token/request — the generation path gates in the engine instead,
    at prompt+max_new token cost. With the default policy (rate 0 =
    unlimited) the gate admits everything, so untagged fleets behave
    exactly as before."""
    global _WSCHED
    with _WSCHED_LOCK:
        if _WSCHED is None:
            from ..scheduling import AdmissionController
            from ..scheduling.schedz import register_controller
            _WSCHED = AdmissionController(
                name=f"worker:{tracing.process_name()}")
            register_controller(_WSCHED)
        return _WSCHED


def arm_wedge_watchdog(backend, app: "ReplicaApp", *,
                       timeout_ms: Optional[float] = None,
                       restart: bool = True,
                       name: Optional[str] = None
                       ) -> Optional[WedgeWatchdog]:
    """Attach the device-wedge watchdog to a backend exposing a
    ``wedge_monitor``: on firing it (1) marks the backend wedged so
    ``/readyz`` flips not-ready and device-lock waiters fail with
    ``ReplicaWedgedError``, (2) counts the event, and (3) with
    ``restart``, requests app shutdown so the worker process exits
    and the supervisor's respawn (a warm start) replaces it. Returns
    None when the backend has no monitor or the timeout disables the
    watchdog."""
    monitor = getattr(backend, "wedge_monitor", None)
    if monitor is None:
        return None

    def _on_wedge():
        _worker_metrics().count_wedge()
        mark = getattr(backend, "mark_wedged", None)
        if mark is not None:
            mark()
        if restart:
            app._request_shutdown()

    wd = WedgeWatchdog(
        monitor, timeout_ms=timeout_ms, on_wedge=_on_wedge,
        name=name or tracing.process_name())
    if not wd.enabled:
        return None
    app.watchdog = wd
    return wd.start()


def arm_canary(backend, app: "ReplicaApp", *,
               period_s: Optional[float] = None,
               name: Optional[str] = None,
               restart: bool = False):
    """Attach the numerics SDC canary to this replica: a deterministic
    checksum sweep every ``period_s`` (default
    ``FLAGS_numerics_canary_period_s``) and on not-ready→ready
    transitions. A backend's ``canary_probe`` (the stub's corruption
    self-check) replaces the device sweep; otherwise the sweep runs on the
    backend's device. On a corruption episode the replica quarantines
    itself: readiness flips red (``/readyz`` reports ``corrupt``), so the
    router's poller opens the replica's breaker and drains it, and the
    backend's ``mark_corrupt`` runs where it has one; with ``restart`` the
    worker also exits for a supervisor respawn. Returns the started
    runner, or None when the period disables it."""
    from ...observability.numerics import CanaryRunner
    if period_s is None:
        period_s = float(
            _flag("FLAGS_numerics_canary_period_s", 0.0) or 0.0)
    probe = getattr(backend, "canary_probe", None)

    def _on_corrupt():
        mark = getattr(backend, "mark_corrupt", None)
        if mark is not None:
            mark()
        if restart:
            app._request_shutdown()

    runner = CanaryRunner(
        name=name or tracing.process_name(), period_s=period_s,
        probe=probe, ready_fn=backend.ready, on_corrupt=_on_corrupt,
        canary_device=getattr(backend, "device", None))
    app.canary = runner
    return runner.start()


# ---------------------------------------------------------------- backends
class PredictorBackend:
    """The real replica backend: a ``Predictor`` loaded from a
    version-stamped artifact prefix, served by an ``InferenceServer``
    with the readiness gate on, optionally alongside a
    ``GenerationServer`` for decode traffic (``generation_kwargs`` go to
    its constructor: ``num_pages``, ``max_batch``, ...). ``device``
    (default: the card; ``"cpu"`` must be asked for) is the predictor's
    and the engine's.

    ``reload(prefix)`` is the hot-swap path: build and warm a complete
    replacement server, swap it in, then drain the old one and release
    its tensors — callers queued on the old server finish on the old
    weights, everything after the swap runs the new ones.
    """

    def __init__(self, model_prefix: str, *,
                 max_batch_size: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_axis: int = 1,
                 warmup_mode: str = "auto",
                 name: str = "replica",
                 generation_model=None,
                 generation_kwargs: Optional[dict] = None,
                 device=None):
        self._name = name
        self._max_batch_size = max_batch_size
        self._seq_buckets = list(seq_buckets) if seq_buckets else None
        self._seq_axis = int(seq_axis)
        self._warmup_mode = warmup_mode
        self._device = device
        self._lock = threading.Lock()
        self._reloading = False
        self._gen = None
        self.wedge_monitor = WedgeMonitor()
        self._server, self._version = self._build(model_prefix)
        if generation_model is not None:
            from ..generation import GenerationServer
            # share the worker's admission controller: the engine
            # gates at token cost and schedules decode WFQ/priority
            self._gen = GenerationServer(generation_model,
                                         name=f"{name}-gen",
                                         scheduler=_worker_scheduler(),
                                         device=generation_model.device,
                                         **(generation_kwargs or {}))

    def _build(self, model_prefix: str):
        from ... import inference
        from ..server import InferenceServer
        cfg = inference.Config(str(model_prefix))
        if self._device is not None:
            import torch
            device = torch.device(self._device)
            if device.type == "cpu":
                cfg.disable_gpu()
            else:
                cfg.enable_use_gpu(100, device.index or 0)
        pred = inference.create_predictor(cfg)
        fp = pred.artifact_fingerprint()
        version = os.path.basename(str(model_prefix)) + \
            (f"@{fp[:8]}" if fp else "")
        # one metrics slice per served version: the replacement server of
        # a swap does not reset the drained one's counts, so the process's
        # /metrics keeps every batch it ran
        # (and one warmup manifest per name and program: the workers of
        # a fleet that share a name replay the signatures any of them
        # served)
        srv = InferenceServer(
            pred, max_batch_size=self._max_batch_size,
            seq_buckets=self._seq_buckets, seq_axis=self._seq_axis,
            name=f"{self._name}/{version}", ready_requires_warmup=True,
            start=True)
        return srv, version

    @property
    def server(self):
        """The ``InferenceServer`` serving now."""
        with self._lock:
            return self._server

    @property
    def generation_server(self):
        return self._gen

    @property
    def device(self):
        """The device the predictor runs on (None: the card), where the
        numerics canary sweeps."""
        return self._device

    # ---- service surface ----
    def submit_many(self, feeds_list, timeout_ms=None,
                    trace_contexts=None):
        futs = self.server.submit_many(feeds_list, timeout_ms=timeout_ms,
                                       trace_contexts=trace_contexts)
        # wedge ledger: one in-flight entry per batch, closed when the
        # LAST future resolves — a batch that never resolves is the
        # hang signature the watchdog fires on
        if futs:
            token = self.wedge_monitor.begin()
            pending = {"n": len(futs)}
            plock = threading.Lock()

            def _done(_):
                with plock:
                    pending["n"] -= 1
                    last = pending["n"] == 0
                if last:
                    self.wedge_monitor.end(token)

            for f in futs:
                f.add_done_callback(_done)
        return futs

    def generate(self, prompt, max_new_tokens, temperature, timeout_ms,
                 seed, deadline_ms=None, tenant=None):
        if self._gen is None:
            raise RuntimeError("this replica hosts no generation "
                               "engine (start it with a generation "
                               "model)")
        return self._gen.submit_generate(
            prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, timeout_ms=timeout_ms, seed=seed,
            deadline_ms=deadline_ms, tenant=tenant)

    def warmup(self) -> int:
        """Warm per ``warmup_mode``: "manifest" replays the persisted
        traffic signatures (the warm scale-out path), "lattice" the full
        bucket lattice, "auto" manifest-when-present else lattice, "none"
        flips ready without running anything; a generation engine that is
        not ready runs its lattice, as the reference's."""
        return self._warm_server(self._server)

    def _warm_server(self, srv) -> int:
        mode = self._warmup_mode
        n = 0
        if mode == "none":
            srv.mark_ready()
        elif mode == "manifest":
            n = srv.warmup_from_manifest()
            srv.mark_ready()   # empty/absent manifest: nothing to warm
        elif mode == "lattice":
            n = srv.warmup()
        else:   # auto
            manifest = srv.warmup_manifest
            if manifest is not None and len(manifest):
                n = srv.warmup_from_manifest()
            else:
                n = srv.warmup()
        if self._gen is not None and not self._gen.ready:
            n += self._gen.warmup()
        return n

    def ready(self) -> bool:
        with self._lock:
            if self._reloading:
                return False
            srv, gen = self._server, self._gen
        return srv.ready and (gen is None or gen.ready)

    def health(self):
        ok, info = self.server._health()
        return ok, {"server": info}

    def reload(self, model_prefix: str) -> str:
        """Swap to the artifact at ``model_prefix``; returns the new
        version stamp. Failure leaves the current server untouched. The
        old server's predictor is released once its drain ends, so device
        memory holds two models only while the swap runs."""
        with self._lock:
            self._reloading = True
        try:
            new_srv, version = self._build(model_prefix)
            try:
                self._warm_server(new_srv)
            except BaseException:
                new_srv.shutdown(drain=False)
                raise
            with self._lock:
                old, self._server = self._server, new_srv
                self._version = version
            old.shutdown(drain=True)
            old.predictor = None
            del old
            _release_device_memory()
            return version
        finally:
            with self._lock:
                self._reloading = False

    def info(self) -> dict:
        with self._lock:
            version = self._version
        return {"backend": "predictor", "version": version,
                "name": self._name,
                "generation": self._gen is not None}

    def shutdown(self, drain: bool = True):
        self.server.shutdown(drain=drain)
        if self._gen is not None:
            self._gen.shutdown(drain=drain)


def _release_device_memory():
    """Hand a released model's cached blocks back to the device."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class StubBackend:
    """Accelerator-emulating backend for fleet benches and tests.

    A real replica on an accelerator spends its request latency
    waiting on the device, not burning host CPU — so on a single-core
    CI box the fleet's process-level parallelism is invisible with
    real CPU-bound models (N processes share one core) but entirely
    real in production. The stub reproduces the production shape:
    one "device" per replica (a lock), ``device_ms`` of held-lock
    sleep per dispatched batch of up to ``max_batch`` rows, a bounded
    outstanding budget that sheds with ``QueueFullError`` (HTTP 429
    through the app), deterministic outputs (``x * scale`` with
    ``scale`` derived from the weight version, so a hot swap is
    observable in the payloads), and optional crash triggers for
    failure-path tests. Everything around it — codec, HTTP, router,
    supervisor — is the production code path.
    """

    def __init__(self, *, device_ms: float = 5.0, max_batch: int = 8,
                 queue_capacity: int = 64, warmup_s: float = 0.0,
                 version: str = "v0",
                 crash_value: Optional[float] = None,
                 crash_mode: str = "drop",
                 hang_value: Optional[float] = None,
                 token_ms: Optional[float] = None):
        self.device_ms = float(device_ms)
        self.max_batch = int(max_batch)
        self.queue_capacity = int(queue_capacity)
        self.warmup_s = float(warmup_s)
        self.crash_value = crash_value
        self.crash_mode = crash_mode
        # hang trigger: a feed matching this value wedges the device —
        # the dispatch holds the device lock and never completes (the
        # watchdog's detection target), unlike crash_value's clean exit
        self.hang_value = hang_value
        self.token_ms = (float(token_ms) if token_ms is not None
                         else self.device_ms / 4.0)
        self._lock = threading.Lock()
        self._device = threading.Lock()   # the one emulated device
        self._outstanding = 0
        self._warmed = False
        self._alive = True
        self._wedged = threading.Event()
        self._hang = threading.Event()
        # SDC emulation: "nan" poisons one output element per array,
        # "bitflip" flips one mantissa bit — both silent (the request
        # still succeeds; only the canary probe / numerics tripwires
        # can tell). Set via /chaos, cleared by restore.
        self._corrupt_mode: Optional[str] = None
        self._quarantined = threading.Event()
        self._version = str(version)
        self._scale = self._scale_of(version)
        self.dispatches = 0
        self.wedge_monitor = WedgeMonitor()

    @staticmethod
    def _scale_of(version: str) -> float:
        # deterministic per-version output scale: v0 -> 1.0, v1 -> 2.0
        import zlib
        return 1.0 + (zlib.crc32(str(version).encode()) % 7)

    def _maybe_crash(self, feeds_list):
        if self.crash_value is None:
            return
        for feeds in feeds_list:
            for a in feeds:
                flat = np.asarray(a).ravel()
                if flat.size and float(flat[0]) == self.crash_value:
                    with self._lock:
                        self._alive = False
                        self._warmed = False
                    if self.crash_mode == "exit":
                        os._exit(17)
                    raise _ConnectionDrop("stub crash trigger")

    def mark_wedged(self):
        """Watchdog hook: flip readiness red and wake every thread
        parked on the device lock with the typed error."""
        self._wedged.set()

    def mark_corrupt(self):
        """Canary quarantine hook (``arm_canary`` on_corrupt): flip
        readiness red so the router drains this replica. Unlike a
        wedge, in-flight work completes — corruption is silent, not
        hung — and ``/chaos restore`` lifts the quarantine."""
        self._quarantined.set()

    @staticmethod
    def _corrupt_array(a: np.ndarray, mode: str) -> np.ndarray:
        a = np.array(a, np.float32, copy=True)
        flat = a.ravel()
        if flat.size:
            if mode == "nan":
                flat[0] = np.nan
            elif mode == "bitflip":
                bits = flat[:1].view(np.uint32)
                bits ^= np.uint32(1 << 22)   # one mantissa bit
        return a

    def _apply_corruption(self, arrays):
        with self._lock:
            mode = self._corrupt_mode
        if mode is None:
            return arrays
        return [self._corrupt_array(a, mode) for a in arrays]

    def canary_probe(self) -> dict:
        """Corruption self-check the canary runs instead of a device
        checksum (there is no accelerator here): round-trip a known
        vector through the SAME output path ``submit_many`` uses and
        compare bit-exactly against the host-computed expectation."""
        with self._lock:
            scale = self._scale
        probe = np.arange(8, dtype=np.float32)
        got = self._apply_corruption([probe * scale])[0]
        want = probe * scale
        ok = got.tobytes() == want.tobytes()
        return {"ok": ok,
                "got_sum": float(np.nansum(got)),
                "want_sum": float(want.sum())}

    def _maybe_hang(self, feeds_list):
        if self.hang_value is None:
            return
        for feeds in feeds_list:
            for a in feeds:
                flat = np.asarray(a).ravel()
                if flat.size and float(flat[0]) == self.hang_value:
                    self._hang.set()

    def _device_acquire(self):
        """Wedge-aware device wait: threads queued behind a hung
        dispatch fail with ``ReplicaWedgedError`` the moment the
        watchdog declares the wedge, instead of blocking forever. A
        waiter that gets the device only because the hung dispatch let
        it go at the wedge fails the same way (the reference's stub lets
        it ride the hang path and drop its connection instead)."""
        while not self._device.acquire(timeout=0.05):
            if self._wedged.is_set():
                raise ReplicaWedgedError(
                    "device wedged: dispatch queued behind a hung "
                    "step, replica restarting")
            with self._lock:
                if not self._alive:
                    raise ServerClosedError("stub backend crashed")
        if self._wedged.is_set():
            self._device.release()
            raise ReplicaWedgedError(
                "device wedged: dispatch queued behind a hung step, "
                "replica restarting")

    def submit_many(self, feeds_list, timeout_ms=None,
                    trace_contexts=None):
        import concurrent.futures
        n = len(feeds_list)
        with self._lock:
            if not self._alive:
                raise ServerClosedError("stub backend crashed")
            if self._wedged.is_set():
                raise ReplicaWedgedError(
                    "device wedged, replica restarting")
            if self._outstanding + n > self.queue_capacity:
                raise QueueFullError(
                    f"stub at capacity ({self.queue_capacity})")
            self._outstanding += n
            scale = self._scale
        try:
            self._maybe_crash(feeds_list)
            self._maybe_hang(feeds_list)
            batches = -(-n // self.max_batch)
            self._device_acquire()  # one device: dispatches serialize
            token = self.wedge_monitor.begin()
            try:
                if self._hang.is_set():
                    # the wedge: hold the device without completing
                    # until the watchdog fires (or shutdown). The
                    # hung dispatch then DROPS its connection (like
                    # the restarting process it emulates) rather than
                    # answering — a typed 503 would invite the router
                    # to retry the wedge-triggering request onto a
                    # healthy replica and cascade the wedge; only the
                    # WAITERS (which never executed) answer with the
                    # re-routable ReplicaWedgedError
                    while not self._wedged.is_set():
                        with self._lock:
                            if not self._alive:
                                raise ServerClosedError(
                                    "stub backend crashed")
                        time.sleep(0.01)
                    raise _ConnectionDrop("device wedged mid-dispatch")
                time.sleep(self.device_ms * batches / 1e3)
                with self._lock:
                    self.dispatches += batches
            finally:
                self.wedge_monitor.end(token)
                self._device.release()
            futs = []
            for feeds in feeds_list:
                f = concurrent.futures.Future()
                f.set_result(self._apply_corruption(
                    [np.asarray(a, np.float32) * scale
                     for a in feeds]))
                futs.append(f)
            return futs
        finally:
            with self._lock:
                self._outstanding -= n

    def generate(self, prompt, max_new_tokens, temperature, timeout_ms,
                 seed, deadline_ms=None, tenant=None):
        from ..generation.engine import StreamingFuture
        fut = StreamingFuture()
        prompt = np.asarray(prompt).ravel()
        base = int(prompt[-1]) if prompt.size else 0
        hard_deadline = (time.monotonic() + float(deadline_ms) / 1e3
                         if deadline_ms else None)

        def _stream():
            for i in range(int(max_new_tokens)):
                time.sleep(self.token_ms / 1e3)
                if hard_deadline is not None and \
                        time.monotonic() > hard_deadline:
                    fut._fail(DeadlineExceededError(
                        "deadline budget expired mid-stream"),
                        reason="deadline")
                    return
                fut._emit((base + 1 + i) % 50000)
                if fut._cancel_requested:
                    fut._finish("cancelled")
                    return
            fut._finish("length")

        threading.Thread(target=_stream, daemon=True).start()
        return fut

    def chaos(self, spec: dict) -> dict:
        """Runtime fault injection (the /chaos control plane the
        chaos harness drives): ``{"device_ms": X}`` inflates per-batch
        device latency (the slow-replica fault), ``{"capacity": N}``
        resizes the shed threshold (0 = reject storm),
        ``{"hang": true}`` wedges the device,
        ``{"corrupt": "nan"|"bitflip"}`` silently corrupts outputs
        (the SDC-drill fault the canary must catch),
        ``{"restore": true}`` lifts latency/capacity/corruption
        faults. Returns the live settings."""
        with self._lock:
            if spec.get("restore"):
                self.device_ms = float(spec.get(
                    "device_ms", self.device_ms))
                self.queue_capacity = int(spec.get(
                    "capacity", self.queue_capacity))
                self._corrupt_mode = None
            else:
                if "device_ms" in spec:
                    self.device_ms = float(spec["device_ms"])
                if "capacity" in spec:
                    self.queue_capacity = int(spec["capacity"])
                if "corrupt" in spec:
                    mode = spec["corrupt"]
                    if mode not in (None, "nan", "bitflip"):
                        raise ValueError(
                            f"unknown corrupt mode {mode!r}")
                    self._corrupt_mode = mode
        if spec.get("restore"):
            self._quarantined.clear()
        if spec.get("hang"):
            self._hang.set()
        return {"device_ms": self.device_ms,
                "capacity": self.queue_capacity,
                "hang": self._hang.is_set(),
                "wedged": self._wedged.is_set(),
                "corrupt": self._corrupt_mode}

    def warmup(self) -> int:
        if self.warmup_s:
            time.sleep(self.warmup_s)
        with self._lock:
            self._warmed = True
        return 0

    def ready(self) -> bool:
        if self._wedged.is_set() or self._quarantined.is_set():
            return False
        with self._lock:
            return self._warmed and self._alive

    def health(self):
        if self._wedged.is_set():
            return False, "wedged"
        with self._lock:
            if not self._alive:
                return False, "crashed"
            return True, {"outstanding": self._outstanding}

    def reload(self, model_prefix: str) -> str:
        version = os.path.basename(str(model_prefix))
        with self._device:      # a swap waits out the in-flight batch
            with self._lock:
                self._version = version
                self._scale = self._scale_of(version)
        return version

    def info(self) -> dict:
        with self._lock:
            return {"backend": "stub", "version": self._version,
                    "device_ms": self.device_ms,
                    "outstanding": self._outstanding,
                    "dispatches": self.dispatches}

    def shutdown(self, drain: bool = True):
        with self._lock:
            self._alive = False

    @property
    def version(self) -> str:
        with self._lock:
            return self._version


# ---------------------------------------------------------------- app
class _ReplicaHandler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-replica/1.0"

    # ---- plumbing ----
    def _send(self, code: int, body: bytes,
              ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj, sort_keys=True).encode())

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    @property
    def _backend(self):
        return self.server.backend  # type: ignore[attr-defined]

    def log_message(self, *args):
        pass

    # ---- control plane ----
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler ABI
        path, _, query = self.path.partition("?")
        try:
            if path == "/tracez":
                # this process's flight recorder — the router's merged
                # /tracez fans out to every replica's
                from ...observability.httpd import tracez_text
                self._send(200, tracez_text(query).encode(),
                           "application/json")
            elif path == "/sloz":
                # this process's SLO evaluation — the router's merged
                # /sloz sums window counts across replicas
                from ...observability.slo import sloz_payload
                self._send(200, json.dumps(
                    sloz_payload(), sort_keys=True).encode(),
                    "application/json")
            elif path == "/schedz":
                # this process's admission/autoscaler state — the
                # router's merged /schedz sums tenant events fleet-wide
                from ..scheduling.schedz import schedz_payload
                _worker_scheduler()   # ensure the gate is registered
                self._send(200, json.dumps(
                    schedz_payload(), sort_keys=True).encode(),
                    "application/json")
            elif path == "/goodputz":
                from ...observability.goodput import goodputz_payload
                self._send(200, json.dumps(
                    goodputz_payload(), sort_keys=True).encode(),
                    "application/json")
            elif path == "/execz":
                # this replica's signature registry; the router's /execz
                # aggregates across replicas
                from ...observability.httpd import execz_text
                self._send(200, execz_text(query).encode(),
                           "application/json")
            elif path == "/profilez":
                # the capture ring, or (?duration_ms=) one bounded
                # capture on THIS replica
                from ...observability.httpd import profilez_response
                code, body = profilez_response(query)
                self._send(code, body.encode(), "application/json")
            elif path == "/numericsz":
                # this process's numerics plane with THIS replica's canary
                # overlaid on the process-wide canary section: with
                # several in-process replicas the shared state reports the
                # last sweep of any of them
                from ...observability.httpd import numericsz_text
                doc = json.loads(numericsz_text(query))
                cn = getattr(self.server.app, "canary", None)
                if cn is not None:
                    doc["canary"] = dict(doc.get("canary") or {},
                                         corrupt=cn.corrupt, last=cn.last)
                self._send(200, json.dumps(doc, sort_keys=True,
                                           default=str).encode(),
                           "application/json")
            elif path == "/healthz":
                ok, info = self._backend.health()
                self._send_json(200 if ok else 503,
                                {"ok": ok, "info": info})
            elif path == "/readyz":
                wd = getattr(self.server.app, "watchdog", None)
                wedged = wd is not None and wd.wedged
                cn = getattr(self.server.app, "canary", None)
                corrupt = cn is not None and cn.corrupt
                ready = (self._backend.ready() and not wedged
                         and not corrupt)
                body = {"ready": ready,
                        "version": self._backend.info().get("version")}
                startup = getattr(self.server.app, "startup", None)
                if ready and startup is not None:
                    body["startup"] = startup
                if wedged:
                    body["wedged"] = True
                if corrupt:
                    # the router's poller opens this replica's breaker on
                    # the flag: SDC quarantine, not just not-ready
                    body["corrupt"] = True
                self._send_json(200 if ready else 503, body)
            elif path == "/metrics":
                from ...observability import (default_registry,
                                              prometheus_text)
                from ...observability.exposition import \
                    PROMETHEUS_CONTENT_TYPE
                self._send(200,
                           prometheus_text(default_registry()).encode(),
                           PROMETHEUS_CONTENT_TYPE)
            elif path == "/statusz":
                # the package beside the backend's info: a supervisor that
                # spawned the wrong package's worker shows at once
                self._send_json(200, dict(self._backend.info(),
                                          package=__package__))
            else:
                self._send(404, b"not found\n", "text/plain")
        except _ConnectionDrop:
            self.close_connection = True
        except Exception as e:  # noqa: BLE001 - a probe bug must not
            try:                # kill the handler thread
                self._send(500, f"{e!r}\n".encode(), "text/plain")
            except Exception:  # noqa: BLE001
                pass

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler ABI
        path, _, query = self.path.partition("?")
        try:
            if path == "/submit_many":
                self._submit_many(query)
            elif path == "/generate":
                self._generate()
            elif path == "/reload":
                req = json.loads(self._body() or b"{}")
                version = self._backend.reload(req["model_prefix"])
                self._send_json(200, {"ok": True, "version": version})
            elif path == "/chaos":
                # stub-only fault-injection control plane (the chaos
                # harness drives slow/reject/hang at runtime)
                chaos = getattr(self._backend, "chaos", None)
                if chaos is None:
                    self._send(501, b"backend has no chaos surface\n",
                               "text/plain")
                else:
                    self._send_json(200, chaos(
                        json.loads(self._body() or b"{}")))
            elif path == "/shutdown":
                self._send_json(200, {"ok": True})
                self.server.app._request_shutdown()  # type: ignore
            else:
                self._send(404, b"not found\n", "text/plain")
        except _ConnectionDrop:
            # crash simulation: vanish mid-request, no response bytes
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
        except QueueFullError as e:
            self._send(429, f"{e}\n".encode(), "text/plain")
        except ReplicaWedgedError as e:
            # wedged = unavailable for anything not already riding the
            # hung dispatch: 503 so the router re-routes safely
            self._send(503, f"{e}\n".encode(), "text/plain")
        except ServerClosedError as e:
            self._send(503, f"{e}\n".encode(), "text/plain")
        except Exception as e:  # noqa: BLE001 - fault barrier for the
            try:                # handler thread
                self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                           "text/plain")
            except Exception:  # noqa: BLE001
                pass

    # ---- data plane ----
    def _submit_many(self, query: str):
        timeout_ms = None
        for part in query.split("&"):
            if part.startswith("timeout_ms="):
                timeout_ms = float(part.split("=", 1)[1]) or None
        feeds_list, traceparents, deadlines, tenants = \
            codec.decode_batch_trailers_ex(self._body())
        ctxs = [tracing.parse_traceparent(tp) if tp else None
                for tp in (traceparents or [])] or None
        # deadline gate BEFORE dispatch: a request whose budget is
        # already exhausted on arrival is answered now and never
        # reaches the device — expiry-at-the-batcher was the only
        # check before deadline propagation landed
        slots: List[Optional[BaseException]] = [None] * len(feeds_list)
        if deadlines is not None:
            expired = [i for i, ms in enumerate(deadlines)
                       if ms is not None and ms <= 0.0]
            for i in expired:
                slots[i] = DeadlineExceededError(
                    "deadline budget exhausted before worker "
                    "dispatch")
            if expired:
                _worker_metrics().count_deadline_reject(len(expired))
        # per-tenant quota gate, AFTER the deadline gate (an already-
        # dead request must not debit its tenant's bucket) and before
        # dispatch: a shed rides the results framing as the typed
        # QuotaExceededError (codec status _ERR_QUOTA), so one noisy
        # tenant never fails its batch peers. Untagged requests map
        # to the 'default' tenant deterministically.
        sched = _worker_scheduler()
        tlist = tenants if tenants is not None \
            else [None] * len(feeds_list)
        for i, t in enumerate(tlist):
            if slots[i] is None:
                try:
                    sched.admit(t, cost=1.0)
                except QuotaExceededError as e:
                    slots[i] = e
        if any(s is not None for s in slots):
            keep = [i for i in range(len(feeds_list))
                    if slots[i] is None]
            feeds_list = [feeds_list[i] for i in keep]
            if ctxs is not None:
                ctxs = [ctxs[i] for i in keep]
        if deadlines is not None:
            live = [ms for i, ms in enumerate(deadlines)
                    if slots[i] is None and ms is not None
                    and ms > 0.0]
            if live:
                # the replica-side scheduling timeout honors the
                # tightest surviving budget
                tight = min(live)
                timeout_ms = tight if timeout_ms is None \
                    else min(timeout_ms, tight)
        if feeds_list:
            lead = next((c for c in (ctxs or []) if c is not None),
                        None)
            if lead is None:
                futs = self._backend.submit_many(
                    feeds_list, timeout_ms=timeout_ms)
                results = self._collect(futs)
            else:
                # one worker-side span per handled batch; requests in
                # the same trace re-parent under it so the stitched
                # view shows router -> worker -> engine stages
                with tracing.start_span(
                        "worker::submit_many", stage="worker",
                        ctx=lead,
                        attrs={"n_req": len(feeds_list),
                               "replica": self._backend.info().get(
                                   "name") or self._backend.info().get(
                                   "version", "")}) as sp:
                    ctxs = [sp.ctx if (c is not None and
                                       c.trace_id == sp.ctx.trace_id)
                            else c for c in ctxs]
                    futs = self._backend.submit_many(
                        feeds_list, timeout_ms=timeout_ms,
                        trace_contexts=ctxs)
                    results = self._collect(futs)
                    if any(isinstance(res, BaseException)
                           for res in results):
                        sp.set_attr("partial_failure", True)
        else:
            results = []
        it = iter(results)
        merged = [slot if slot is not None else next(it)
                  for slot in slots]
        self._send(200, codec.encode_results(merged),
                   "application/x-paddle-fleet")

    def _collect(self, futs):
        results = []
        for f in futs:
            try:
                results.append(f.result(timeout=self.server.app
                                        .request_timeout_s))
            except BaseException as e:  # noqa: BLE001 - per-request
                results.append(e)       # failures ride the framing
        return results

    def _generate(self):
        req = json.loads(self._body() or b"{}")
        # ambient context for the submit: GenerationServer captures it
        # into the request, so decode spans land in the caller's trace
        ctx = tracing.parse_traceparent(req.get("traceparent"))
        # tenant: JSON field wins, else the x-paddle-tenant header
        # (the router stamps the field; raw clients send the header)
        tenant = req.get("tenant") or \
            self.headers.get("x-paddle-tenant")
        kwargs = {"deadline_ms": req.get("deadline_ms")}
        if tenant is not None:
            # tenant-blind backends (pre-PDTN generate signature)
            # keep working: only pass the kwarg when they take it
            import inspect
            try:
                params = inspect.signature(
                    self._backend.generate).parameters
                if "tenant" in params or any(
                        p.kind == p.VAR_KEYWORD
                        for p in params.values()):
                    kwargs["tenant"] = tenant
            except (TypeError, ValueError):
                kwargs["tenant"] = tenant
        with tracing.use_context(ctx):
            fut = self._backend.generate(
                np.asarray(req["prompt"], np.int64),
                int(req.get("max_new_tokens", 32)),
                float(req.get("temperature", 0.0)),
                req.get("timeout_ms"), req.get("seed"), **kwargs)
        # close-delimited stream: one JSON line per token event, then
        # the terminal line with the finish reason
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            for tok in fut:
                self.wfile.write(
                    json.dumps({"t": int(tok)}).encode() + b"\n")
                self.wfile.flush()
            self.wfile.write(json.dumps(
                {"done": True,
                 "finish_reason": fut.finish_reason}).encode() + b"\n")
        except BrokenPipeError:
            fut.cancel()        # client went away: stop generating
        except BaseException as e:  # noqa: BLE001 - stream the error
            reason = "deadline" \
                if isinstance(e, DeadlineExceededError) else "error"
            try:
                self.wfile.write(json.dumps(
                    {"done": True, "finish_reason": reason,
                     "error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n")
            except OSError:
                pass


class _ReplicaServer(ThreadingHTTPServer):
    # a router's pool opens tens of connections at once: the standard
    # library's listen backlog of 5 overflows under load, and the kernel
    # then drops or resets connections a busy replica has not accepted yet
    request_queue_size = 128
    daemon_threads = False      # server_close joins the handler threads


class ReplicaApp:
    """One ThreadingHTTPServer bound to a backend, on a daemon
    thread. ``port=0`` binds ephemeral; read ``.port`` / ``.url``
    back. ``stop()`` waits for the requests already accepted to be
    answered (their handler threads are joined), so a worker that exits
    — at a wedge, a scale-in or a shutdown — answers what it took; the
    reference's daemon handlers die with the process instead."""

    def __init__(self, backend, host: str = "127.0.0.1",
                 port: int = 0,
                 request_timeout_s: Optional[float] = None):
        self.backend = backend
        self.host = host
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else _flag("FLAGS_fleet_request_timeout_s", 120.0))
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown_requested = threading.Event()
        self.watchdog: Optional[WedgeWatchdog] = None
        self.canary = None      # CanaryRunner via arm_canary
        # a worker's start-up split (main), served in /readyz once ready
        self.startup: Optional[dict] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ReplicaApp":
        if self._httpd is not None:
            return self
        httpd = _ReplicaServer((self.host, self._requested_port),
                               _ReplicaHandler)
        httpd.backend = self.backend        # type: ignore[attr-defined]
        httpd.app = self                    # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="fleet-replica-http",
            daemon=True)
        self._thread.start()
        return self

    def _request_shutdown(self):
        self._shutdown_requested.set()

    def wait_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_requested.wait(timeout)

    def stop(self):
        cn, self.canary = self.canary, None
        if cn is not None:
            cn.stop()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)


# ---------------------------------------------------------------- local
class ThreadReplicaFactory:
    """Spawns replicas as threads in THIS process — the supervisor's
    test double and the single-process deployment mode. Each "process"
    is a ReplicaApp over a backend built by ``backend_factory``;
    ``kill()`` drops it abruptly (closed sockets, exit code 1), like a
    SIGKILLed worker."""

    def __init__(self, backend_factory):
        self.backend_factory = backend_factory
        self.spawned: List["_ThreadReplica"] = []

    def __call__(self, replica_id: int) -> "_ThreadReplica":
        rep = _ThreadReplica(self.backend_factory(replica_id))
        self.spawned.append(rep)
        return rep


class _ThreadReplica:
    """ReplicaProcess protocol over an in-thread ReplicaApp."""

    def __init__(self, backend):
        self.backend = backend
        self.app = ReplicaApp(backend).start()
        self._rc: Optional[int] = None
        self.pid = -os.getpid()     # marks "not a real process"
        backend.warmup()

    def url(self) -> Optional[str]:
        return self.app.url if self._rc is None else None

    def poll(self) -> Optional[int]:
        if self._rc is None and self.app.wait_shutdown(0):
            self._rc = 0
        return self._rc

    def terminate(self):
        if self._rc is None:
            self.backend.shutdown(drain=True)
            self.app.stop()
            self._rc = 0

    def kill(self):
        if self._rc is None:
            self.backend.shutdown(drain=False)
            self.app.stop()
            self._rc = 1

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.poll()


# ---------------------------------------------------------------- main
def _parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch fleet replica worker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--announce", default=None,
                    help="announce-file path the supervisor polls")
    ap.add_argument("--model-prefix", default=None)
    ap.add_argument("--warmup", default="auto",
                    choices=("auto", "manifest", "lattice", "none"),
                    help="manifest replays the warmup manifests under "
                         "FLAGS_compile_cache_dir, lattice the bucket "
                         "lattice, auto the manifest when it has "
                         "entries, none nothing")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (Config.disable_gpu()); the "
                         "default is the card")
    ap.add_argument("--max-batch-size", type=int, default=0)
    ap.add_argument("--seq-buckets", default="",
                    help="comma list, e.g. 8,16,32 ('' = no seq "
                         "bucketing)")
    ap.add_argument("--name", default=None)
    ap.add_argument("--generation-preset", default="",
                    help="'tiny' hosts a seeded gpt_tiny "
                         "GenerationServer next to the predictor")
    ap.add_argument("--stub", action="store_true",
                    help="accelerator-emulating stub backend (no "
                         "model; fleet benches + failure drills)")
    ap.add_argument("--stub-device-ms", type=float, default=5.0)
    ap.add_argument("--stub-max-batch", type=int, default=8)
    ap.add_argument("--stub-capacity", type=int, default=64)
    ap.add_argument("--stub-warmup-s", type=float, default=0.0)
    ap.add_argument("--stub-version", default="v0")
    ap.add_argument("--stub-crash-value", type=float, default=None)
    ap.add_argument("--stub-crash-mode", default="exit",
                    choices=("exit", "drop"))
    ap.add_argument("--stub-hang-value", type=float, default=None,
                    help="a feed matching this value wedges the "
                         "stub's device (the dispatch never "
                         "completes; the wedge watchdog's target)")
    ap.add_argument("--wedge-timeout-ms", type=float, default=None,
                    help="device-wedge watchdog timeout (default: "
                         "FLAGS_fleet_wedge_timeout_ms; <= 0 off)")
    ap.add_argument("--canary-period-s", type=float, default=None,
                    help="numerics SDC canary sweep period (default: "
                         "FLAGS_numerics_canary_period_s; <= 0 off)")
    return ap.parse_args(argv)


def _build_backend(args):
    if args.stub:
        return StubBackend(
            device_ms=args.stub_device_ms,
            max_batch=args.stub_max_batch,
            queue_capacity=args.stub_capacity,
            warmup_s=args.stub_warmup_s,
            version=args.stub_version,
            crash_value=args.stub_crash_value,
            crash_mode=args.stub_crash_mode,
            hang_value=args.stub_hang_value)
    if not args.model_prefix:
        raise SystemExit("worker: need --model-prefix or --stub")
    from ...framework.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    gen_model = None
    if args.generation_preset:
        if args.generation_preset != "tiny":
            raise SystemExit(f"worker: unknown --generation-preset "
                             f"{args.generation_preset!r} (tiny)")
        from ...models import GPTForCausalLM, gpt_tiny
        gen_model = GPTForCausalLM(gpt_tiny(), device=device, seed=0)
    buckets = [int(b) for b in args.seq_buckets.split(",") if b]
    return PredictorBackend(
        args.model_prefix,
        max_batch_size=args.max_batch_size or None,
        seq_buckets=buckets or None,
        warmup_mode=args.warmup,
        name=args.name or f"replica-{os.getpid()}",
        generation_model=gen_model, device=device)


def _startup_split(args) -> tuple:
    """Build the backend the way ``main`` does, timing each part of a
    worker's start-up in seconds: ``imports`` (the process's start to
    here: the interpreter and the imports), ``cuda_context`` (the CUDA
    context on the card), ``kernel_library`` (loading, or building, the
    hand-written kernels' library), ``model`` (the backend: the artifact
    and any generation model). Returns ``(backend, split)``; the caller
    adds ``warmup``."""
    import torch
    from ...observability.runtime import startup_split
    # without a card the backend's build raises the device error itself
    split = startup_split(not args.stub and not args.cpu
                          and torch.cuda.is_available())
    t = time.time()
    backend = _build_backend(args)
    split["model"] = round(time.time() - t, 4)
    return backend, split


def _warm_report(backend) -> dict:
    """What the warmup left, read before any traffic: the compile cache's
    hits and misses in this process (None without a cache) and the
    signatures the server's warmup manifest held."""
    import sys
    cc = sys.modules.get("paddle_tpu_torch.compile_cache")
    st = cc.stats() if cc is not None else None
    srv = getattr(backend, "server", None)
    manifest = getattr(srv, "warmup_manifest", None)
    return {"compile_cache": ({"hits": st["hits"], "misses": st["misses"]}
                              if st is not None else None),
            "manifest_signatures": (len(manifest.specs(site="predict"))
                                    if manifest is not None else None)}


def main(argv=None) -> int:
    import signal

    args = _parse_args(argv)
    tracing.set_process_name(args.name or f"replica-{os.getpid()}")
    backend, split = _startup_split(args)
    app = ReplicaApp(backend, host=args.host,
                     port=args.port).start()
    # the watchdog turns a wedged device into a bounded failure: flip
    # readiness, fail device waiters, exit — the supervisor respawns
    wd = arm_wedge_watchdog(backend, app,
                            timeout_ms=args.wedge_timeout_ms)
    # the canary turns silent data corruption into a quarantine (off at
    # the default period)
    arm_canary(backend, app, period_s=args.canary_period_s)
    if args.announce:
        write_announce_file(args.announce, app.port)

    def _sigterm(signum, frame):
        app._request_shutdown()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
        signal.signal(signal.SIGINT, _sigterm)
    except ValueError:
        pass    # not the main thread (embedded use)
    # liveness is up (the app answers /healthz) but readiness stays
    # false until this warmup pass — the whole point of the split
    t0 = time.time()
    backend.warmup()
    split["warmup"] = round(time.time() - t0, 4)
    split.update(_warm_report(backend))
    app.startup = split
    app.wait_shutdown()
    backend.shutdown(drain=True)
    if wd is not None and wd.wedged:
        # a wedged worker answers one more health interval, /readyz red,
        # so the router's poll reads "not ready, wedged" rather than a
        # dead socket before the supervisor's respawn
        time.sleep(float(_flag("FLAGS_fleet_health_interval_ms", 200.0))
                   / 1e3)
    app.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
