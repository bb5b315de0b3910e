"""Telemetry HTTP endpoint (the port of ``paddle_tpu/observability/httpd.py``):
standard-library ``http.server``, no dependencies.

Serves off a daemon thread:

- ``/metrics``: Prometheus text format (0.0.4); ``?format=json`` or an
  ``Accept: application/json`` header switches to the JSON mirror;
- ``/healthz``: runs the registered health checks, 200 when all pass, 503
  otherwise, JSON body either way (liveness: the process is up and its
  workers have not died);
- ``/readyz``: runs the registered readiness checks, same contract
  (readiness: the process may be handed traffic; a warming server is
  alive but not ready);
- ``/statusz``: process status (pid, uptime, torch and its devices, live
  serving servers, live decode engines with their page accounting and
  per-tenant queue depths, metric family count);
- ``/tracez``: the trace flight recorder (``tracing.tracez_payload``);
  ``?trace_id=``, ``?min_ms=``, ``?limit=``, ``?format=chrome``;
- ``/sloz``: declared SLOs with rolling-window attainment, burn rates and
  firing alerts (evaluated at scrape time);
- ``/schedz``: multi-tenant admission state (per-tenant token buckets and
  event counts);
- ``/goodputz``: the goodput ledger's accounting report and the step
  profiler's summary (``goodput.goodputz_payload``);
- ``/execz``: the signature registry (``xstats.execz_payload``): every
  site's signatures with the FLOPs, bytes and allocator memory measured at
  their first dispatch (provenance tier ``eager``; the byte count is an
  upper bound), per-site rollups and the live per-kind MFU and bandwidth
  utilization;
- ``/profilez``: the profile-capture ring; ``?duration_ms=`` runs one
  bounded, rate-limited ``torch.profiler`` capture and returns the chrome
  trace (429 when the rate limit or an in-flight capture refuses it, 409
  while another profiler session is active);
- ``/numericsz``: the numerics plane (``numerics.numericsz_payload``):
  tripwire health, shadow divergences, int8 scale drift, the canary and the
  anomaly ledger.

``InferenceServer`` and ``GenerationServer`` attach through
``telemetry_port=`` or ``FLAGS_serving_telemetry_port`` (-1 disabled, 0
ephemeral, >0 fixed); scripts call ``start_telemetry_server()``. One
shared server per process: the registry is process-wide, so one scrape
endpoint serves every subsystem. A port that cannot be bound raises
``OSError`` to the caller.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .exposition import PROMETHEUS_CONTENT_TYPE, json_text, prometheus_text
from .registry import MetricRegistry, default_registry

__all__ = [
    "TelemetryServer", "start_telemetry_server", "get_telemetry_server",
    "stop_telemetry_server", "add_health_check", "remove_health_check",
    "healthz", "add_readiness_check", "remove_readiness_check",
    "readyz", "tracez_text", "execz_text", "profilez_response",
    "numericsz_text",
]

_start_time = time.time()

# ---------------------------------------------------------------- health
_health_lock = threading.Lock()
_health_checks: Dict[str, Callable] = {}
_readiness_checks: Dict[str, Callable] = {}


def add_health_check(name: str, fn: Callable):
    """Register ``fn() -> bool | (bool, info)``; raising counts as
    unhealthy. All checks must pass for /healthz to return 200."""
    with _health_lock:
        _health_checks[name] = fn


def remove_health_check(name: str):
    with _health_lock:
        _health_checks.pop(name, None)


def add_readiness_check(name: str, fn: Callable):
    """Register a readiness probe (the same ``fn() -> bool | (bool,
    info)`` contract as health checks): all must pass for /readyz to
    return 200. Readiness means "send me traffic", health "the process is
    alive"."""
    with _health_lock:
        _readiness_checks[name] = fn


def remove_readiness_check(name: str):
    with _health_lock:
        _readiness_checks.pop(name, None)


def _run_checks(checks: Dict[str, Callable],
                unhealthy: str) -> Tuple[bool, dict]:
    ok, detail = True, {}
    for name, fn in checks.items():
        try:
            res = fn()
            if isinstance(res, tuple):
                c_ok, info = bool(res[0]), res[1]
            else:
                c_ok, info = bool(res), None
        except Exception as e:  # noqa: BLE001 - a raising probe is a
            c_ok, info = False, repr(e)  # failing probe, not a crash
        detail[name] = {"ok": c_ok}
        if info is not None:
            detail[name]["info"] = info
        ok = ok and c_ok
    return ok, {"status": "ok" if ok else unhealthy, "checks": detail}


def healthz() -> Tuple[bool, dict]:
    with _health_lock:
        checks = dict(_health_checks)
    return _run_checks(checks, "unhealthy")


def readyz() -> Tuple[bool, dict]:
    """Run the registered readiness checks. With none registered the
    process is vacuously ready (as /healthz)."""
    with _health_lock:
        checks = dict(_readiness_checks)
    return _run_checks(checks, "not ready")


def _statusz() -> dict:
    out = {
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _start_time, 3),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
    }
    try:
        out["metric_families"] = len(default_registry().collect())
    except Exception:  # noqa: BLE001
        pass
    try:  # live serving servers (lazy: serving may not be imported)
        serving_metrics = sys.modules.get(
            "paddle_tpu_torch.serving.metrics")
        if serving_metrics is not None:
            out["serving_servers"] = sorted(serving_metrics.all_snapshots())
    except Exception:  # noqa: BLE001
        pass
    try:  # live decode engines: prefix-cache and page accounting (with
        # the refcount-leak check) and per-tenant queue depths
        gen_engine = sys.modules.get(
            "paddle_tpu_torch.serving.generation.engine")
        if gen_engine is not None:
            engines = gen_engine.engines_statusz()
            if engines:
                out["decode_engines"] = engines
    except Exception:  # noqa: BLE001
        pass
    try:
        torch = sys.modules.get("torch")
        if torch is not None:
            cuda = torch.cuda.is_available()
            out["torch"] = {"version": torch.__version__,
                            "cuda": torch.version.cuda,
                            "cuda_available": cuda,
                            "device_count": (torch.cuda.device_count()
                                             if cuda else 0)}
    except Exception:  # noqa: BLE001
        pass
    try:  # the compile cache's health (hits/misses/fallbacks/entries/
        # bytes) without scraping /metrics, as the reference's section;
        # absent until the cache package is imported
        cc = sys.modules.get("paddle_tpu_torch.compile_cache")
        if cc is not None:
            section = dict(cc.stats())
            from ..framework.flags import flag_value
            section["dir"] = str(flag_value("FLAGS_compile_cache_dir") or "")
            section["enabled"] = bool(section["dir"])
            out["compile_cache"] = section
    except Exception:  # noqa: BLE001
        pass
    try:  # numerics health (lazy: absent until the numerics layer is
        # imported)
        num = sys.modules.get("paddle_tpu_torch.observability.numerics")
        if num is not None:
            out["numerics"] = num.numericsz_payload()
    except Exception:  # noqa: BLE001
        pass
    return out


def tracez_text(query: str) -> str:
    """The ``/tracez`` body: the flight recorder's recent traces as JSON.
    Query params: ``trace_id=<32hex>`` (one trace), ``min_ms=<float>``
    (only traces at least that long), ``limit=<n>`` (newest-first cap,
    default 100), and ``format=chrome`` for a chrome-trace document of
    the selected spans instead of the tracez schema."""
    from urllib.parse import parse_qs

    from . import tracing
    q = {k: v[-1] for k, v in parse_qs(query).items()}
    trace_id = q.get("trace_id") or None
    min_ms = float(q["min_ms"]) if q.get("min_ms") else None
    limit = int(q.get("limit", 100))
    payload = tracing.tracez_payload(trace_id=trace_id,
                                     min_duration_ms=min_ms, limit=limit)
    if q.get("format") == "chrome":
        spans = [s for t in payload["traces"] for s in t["spans"]]
        return json.dumps(
            {"traceEvents": tracing.chrome_trace_events(spans)})
    return json.dumps(payload, indent=1, sort_keys=True)


def execz_text(query: str = "") -> str:
    """The ``/execz`` body: the signature registry with per-site rollups
    and the per-kind MFU / roofline join state. ``?compute=0`` is taken
    for the reference's surface (nothing is computed at scrape time).
    Shared by the telemetry endpoint and replica workers; the router
    aggregates replica payloads."""
    from . import xstats
    compute = "compute=0" not in (query or "")
    return json.dumps(xstats.execz_payload(compute=compute),
                      indent=1, sort_keys=True, default=str)


def numericsz_text(query: str = "") -> str:
    """The ``/numericsz`` body (``numerics.numericsz_payload``). Shared by
    the telemetry endpoint and replica workers; the router merges replica
    payloads into a fleet view."""
    del query  # no parameters yet; the signature matches its siblings
    from . import numerics
    return json.dumps(numerics.numericsz_payload(), indent=1,
                      sort_keys=True, default=str)


def profilez_response(query: str = "") -> Tuple[int, str]:
    """The ``/profilez`` behaviour of every HTTP surface: without
    ``duration_ms``, the capture ring; with it, one bounded, rate-limited
    capture and its chrome-trace document (429 when the rate limit or an
    in-flight capture refuses it; 409, typed, while another profiler
    session is active). Returns ``(status, body)``; JSON either way."""
    from urllib.parse import parse_qs

    from . import xstats
    q = {k: v[-1] for k, v in parse_qs(query or "").items()}
    if not q.get("duration_ms"):
        return 200, json.dumps(xstats.profilez_payload(), indent=1,
                               sort_keys=True)
    try:
        got = xstats.capture_profile(float(q["duration_ms"]),
                                     reason=q.get("reason", "manual"))
    except xstats.ProfilerBusyError as e:
        return 409, json.dumps(
            {"error": str(e), "type": "ProfilerBusyError",
             "ring": xstats.profilez_payload()}, indent=1, sort_keys=True)
    if got is None:
        return 429, json.dumps(
            {"error": "capture rate-limited or already in flight",
             "ring": xstats.profilez_payload()}, indent=1,
            sort_keys=True)
    _meta, doc = got
    return 200, json.dumps(doc)


# ---------------------------------------------------------------- server
class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-telemetry/1.0"

    def _send(self, code: int, body: str, ctype: str):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, doc):
        self._send(code, json.dumps(doc, indent=1, sort_keys=True,
                                    default=str), "application/json")

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler ABI
        path, _, query = self.path.partition("?")
        registry = self.server.registry  # type: ignore[attr-defined]
        try:
            if path == "/metrics":
                want_json = ("format=json" in query or "application/json"
                             in (self.headers.get("Accept") or ""))
                if want_json:
                    self._send(200, json_text(registry, indent=1),
                               "application/json")
                else:
                    self._send(200, prometheus_text(registry),
                               PROMETHEUS_CONTENT_TYPE)
            elif path == "/healthz":
                ok, detail = healthz()
                self._json(200 if ok else 503, detail)
            elif path == "/readyz":
                ok, detail = readyz()
                self._json(200 if ok else 503, detail)
            elif path == "/statusz":
                self._json(200, _statusz())
            elif path == "/tracez":
                self._send(200, tracez_text(query), "application/json")
            elif path == "/sloz":
                from .slo import sloz_payload
                self._json(200, sloz_payload())
            elif path == "/schedz":
                from ..serving.scheduling.schedz import schedz_payload
                self._json(200, schedz_payload())
            elif path == "/goodputz":
                from .goodput import goodputz_payload
                self._json(200, goodputz_payload())
            elif path == "/execz":
                self._send(200, execz_text(query), "application/json")
            elif path == "/profilez":
                code, body = profilez_response(query)
                self._send(code, body, "application/json")
            elif path == "/numericsz":
                self._send(200, numericsz_text(query), "application/json")
            elif path == "/":
                self._send(200, "paddle-tpu telemetry\n"
                                "/metrics  /healthz  /readyz  /statusz  "
                                "/tracez  /sloz  /schedz  /goodputz  "
                                "/execz  /profilez  /numericsz\n",
                           "text/plain; charset=utf-8")
            else:
                self._send(404, "not found\n", "text/plain; charset=utf-8")
        except Exception as e:  # noqa: BLE001 - a scrape bug must never
            try:                # kill the handler thread
                self._send(500, f"internal error: {e!r}\n",
                           "text/plain; charset=utf-8")
            except Exception:  # noqa: BLE001
                pass

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class TelemetryServer:
    """Owns one ThreadingHTTPServer on a daemon thread. ``port=0`` binds
    an ephemeral port; read the actual one back from ``.port``. ``start``
    raises ``OSError`` when the port cannot be bound."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry: Optional[MetricRegistry] = None):
        self._requested_port = int(port)
        self.host = host
        self.registry = registry or default_registry()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path: str = "/metrics") -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        return f"http://{host}:{self.port}{path}"

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        httpd.registry = self.registry  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="telemetry-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


_singleton_lock = threading.Lock()
_singleton: Optional[TelemetryServer] = None


def start_telemetry_server(port: Optional[int] = None,
                           host: str = "0.0.0.0",
                           registry: Optional[MetricRegistry] = None,
                           install_collectors: bool = True
                           ) -> TelemetryServer:
    """Start (or return) the shared process-wide telemetry endpoint. With
    ``install_collectors`` (the default) the runtime collectors are
    installed on first start (``runtime.install_all``: device memory, the
    kernel library's compile event, build info, and span mirroring when
    ``FLAGS_profiler_span_metrics`` is on), so a bare scrape already
    carries them. A bind failure raises ``OSError``."""
    global _singleton
    with _singleton_lock:
        if _singleton is not None and _singleton.running:
            return _singleton
        srv = TelemetryServer(port=0 if port is None else int(port),
                              host=host, registry=registry)
        srv.start()
        _singleton = srv
    if install_collectors:
        try:
            from . import runtime
            runtime.install_all(registry)
        except Exception:  # noqa: BLE001 - collectors are best-effort;
            pass           # the endpoint itself must come up regardless
    return _singleton


def get_telemetry_server() -> Optional[TelemetryServer]:
    with _singleton_lock:
        return _singleton


def stop_telemetry_server():
    global _singleton
    with _singleton_lock:
        srv, _singleton = _singleton, None
    if srv is not None:
        srv.stop()
