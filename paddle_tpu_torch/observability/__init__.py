"""The port's telemetry layer (the counterpart of
``paddle_tpu/observability``), the one place every subsystem reports into:

- ``registry``: typed metric families (``Counter``, ``Gauge``,
  ``Histogram``) with Prometheus-style label sets, scrape-time collectors,
  and ``PercentileWindow``, the bounded-window percentile estimator shared
  with ``serving.metrics``;
- ``exposition``: Prometheus text format 0.0.4 and a JSON mirror;
- ``httpd``: a standard-library endpoint (``/metrics``, ``/healthz``,
  ``/readyz``, ``/statusz``, ``/tracez``, ``/sloz``, ``/schedz``) that
  ``InferenceServer`` and ``GenerationServer`` attach through
  ``FLAGS_serving_telemetry_port`` and scripts start with
  ``start_telemetry_server()``;
- ``tracing``: request traces, typed per-stage spans into a bounded
  flight recorder (``/tracez``), head sampling
  (``FLAGS_trace_sample_rate``) with error/shed/deadline tail promotion,
  latency-histogram exemplars and a chrome-trace exporter;
- ``stepprof``: the continuous step profiler, a bounded ring of per-step
  envelopes with an EWMA+MAD straggler detector that promotes slow steps
  into the flight recorder;
- ``slo``: declarative latency SLOs over rolling windows of the latency
  histograms, multi-window multi-burn-rate alerts (``/sloz``, alert
  sinks, ``paddle_slo_*`` gauges).

Not ported yet, each name raising ``NotImplementedError`` that names its
ROADMAP queue 1 item: ``goodput`` and ``training`` (item 5b, elastic
training), ``runtime``, ``xstats`` and ``numerics`` (item 11).
``framework.monitor``'s stat_add/stat_get are a Counter view onto the
default registry; ``serving.ServingMetrics`` is backed by these types.
"""
from __future__ import annotations

from . import exposition, httpd, registry, slo, stepprof, tracing  # noqa
from ._unported import not_ported
from .exposition import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE, json_snapshot, json_text, prometheus_text,
)
from .httpd import (  # noqa: F401
    TelemetryServer, add_health_check, add_readiness_check,
    get_telemetry_server, healthz, readyz, remove_health_check,
    remove_readiness_check, start_telemetry_server, stop_telemetry_server,
)
from .registry import (  # noqa: F401
    DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram, MetricRegistry,
    PercentileWindow, default_registry, sanitize_metric_name,
)
from .slo import (  # noqa: F401
    BurnRule, LatencySLO, SLOMonitor, add_alert_sink, default_monitor,
    latency_slo, remove_alert_sink, set_default_monitor, sloz_payload,
)
from .stepprof import (  # noqa: F401
    StepProfiler, default_profiler, record_step, set_default_profiler,
)
from .tracing import (  # noqa: F401
    Span, SpanBuffer, TraceContext, current_context, default_buffer,
    export_chrome_trace, new_context, parse_traceparent, record_exemplar,
    record_span, request_context, start_span, tracez_payload, use_context,
)

_ELASTIC = "item 5b (elastic training: goodput.py, training.py)"
_RUNTIME = "item 11 (runtime.py, xstats.py, numerics.py)"
_UNPORTED = {
    **{n: _ELASTIC for n in (
        "goodput", "GoodputLedger", "default_ledger", "set_default_ledger",
        "goodput_report", "goodputz_payload", "training",
        "TrainingTelemetryCallback", "instrument_optimizers",
        "uninstrument_optimizers")},
    **{n: _RUNTIME for n in (
        "runtime", "install_jax_monitoring",
        "install_device_memory_collector", "mirror_profiler_spans",
        "install_build_info", "xstats", "ExecEntry", "ExecRegistry",
        "ProfileRing", "default_exec_registry", "default_profile_ring",
        "register_executable", "device_peaks", "execz_payload",
        "profilez_payload", "capture_profile", "numerics", "CanaryRunner",
        "note_serving_logits", "note_shadow_divergence",
        "numericsz_payload", "run_device_canary")},
}
globals().update({n: not_ported(n, item) for n, item in _UNPORTED.items()})

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "PercentileWindow", "default_registry",
    "sanitize_metric_name", "DEFAULT_MS_BUCKETS",
    "prometheus_text", "json_snapshot", "json_text",
    "PROMETHEUS_CONTENT_TYPE",
    "TelemetryServer", "start_telemetry_server", "get_telemetry_server",
    "stop_telemetry_server", "add_health_check", "remove_health_check",
    "healthz", "add_readiness_check", "remove_readiness_check", "readyz",
    "StepProfiler", "default_profiler", "set_default_profiler",
    "record_step",
    "BurnRule", "LatencySLO", "SLOMonitor", "default_monitor",
    "set_default_monitor", "latency_slo", "add_alert_sink",
    "remove_alert_sink", "sloz_payload",
    "TraceContext", "Span", "SpanBuffer", "new_context",
    "request_context", "current_context", "use_context",
    "parse_traceparent", "start_span", "record_span",
    "default_buffer", "tracez_payload", "export_chrome_trace",
    "record_exemplar",
    "registry", "exposition", "httpd", "tracing", "stepprof", "slo",
    *_UNPORTED,
]
