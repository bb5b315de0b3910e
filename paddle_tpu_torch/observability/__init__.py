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
  sinks, ``paddle_slo_*`` gauges);
- ``goodput``: the goodput ledger, wall-clock accounting of a training
  run into typed categories that sum to elapsed time (``/goodputz``),
  fed by ``jit.TrainStep``, the fit callback and the elastic
  ``CheckpointManager``;
- ``training``: ``TrainingTelemetryCallback`` (the ``paddle_training_*``
  families, goodput step frames and step envelopes from ``Model.fit``)
  and ``instrument_optimizers`` (the ``paddle_optimizer_*`` families from
  the optimizers' step observers);
- ``runtime``: the collectors a telemetry endpoint installs (the kernel
  library's compile event, the caching allocator's device memory, profiler
  span mirroring, build info);
- ``xstats``: the signature registry measured at each signature's first
  dispatch (``/execz``, ``paddle_mfu{kind=}``) and the ``torch.profiler``
  capture ring (``/profilez``);
- ``numerics``: NaN/Inf tripwires, shadow checks of the paged kernels
  against their plain versions, int8 scale drift and the SDC canary
  (``/numericsz``).

Every name of the reference's surface is offered (87 of 87).
``framework.monitor``'s stat_add/stat_get are a Counter view onto the
default registry; ``serving.ServingMetrics`` is backed by these types.
"""
from __future__ import annotations

from . import (exposition, goodput, httpd, numerics,  # noqa: F401
               registry, runtime, slo, stepprof, tracing, training, xstats)
from .exposition import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE, json_snapshot, json_text, prometheus_text,
)
from .goodput import (  # noqa: F401
    GoodputLedger, default_ledger, goodput_report, goodputz_payload,
    set_default_ledger,
)
from .httpd import (  # noqa: F401
    TelemetryServer, add_health_check, add_readiness_check,
    get_telemetry_server, healthz, readyz, remove_health_check,
    remove_readiness_check, start_telemetry_server, stop_telemetry_server,
)
from .numerics import (  # noqa: F401
    CanaryRunner, note_serving_logits, note_shadow_divergence,
    numericsz_payload, run_device_canary,
)
from .registry import (  # noqa: F401
    DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram, MetricRegistry,
    PercentileWindow, default_registry, sanitize_metric_name,
)
from .runtime import (  # noqa: F401
    install_build_info, install_device_memory_collector,
    install_jax_monitoring, mirror_profiler_spans,
)
from .slo import (  # noqa: F401
    BurnRule, LatencySLO, SLOMonitor, add_alert_sink, default_monitor,
    latency_slo, remove_alert_sink, set_default_monitor, sloz_payload,
)
from .stepprof import (  # noqa: F401
    StepProfiler, default_profiler, record_step, set_default_profiler,
)
from .training import (  # noqa: F401
    TrainingTelemetryCallback, instrument_optimizers, uninstrument_optimizers,
)
from .tracing import (  # noqa: F401
    Span, SpanBuffer, TraceContext, current_context, default_buffer,
    export_chrome_trace, new_context, parse_traceparent, record_exemplar,
    record_span, request_context, start_span, tracez_payload, use_context,
)

from .xstats import (  # noqa: F401
    ExecEntry, ExecRegistry, ProfileRing, capture_profile,
    default_exec_registry, default_profile_ring, device_peaks,
    execz_payload, profilez_payload, register_executable,
)

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
    "GoodputLedger", "default_ledger", "set_default_ledger",
    "goodput_report", "goodputz_payload", "TrainingTelemetryCallback",
    "instrument_optimizers", "uninstrument_optimizers",
    "install_jax_monitoring", "install_device_memory_collector",
    "mirror_profiler_spans", "install_build_info",
    "ExecEntry", "ExecRegistry", "ProfileRing",
    "default_exec_registry", "default_profile_ring",
    "register_executable", "device_peaks", "execz_payload",
    "profilez_payload", "capture_profile",
    "CanaryRunner", "note_serving_logits", "note_shadow_divergence",
    "numericsz_payload", "run_device_canary",
    "registry", "exposition", "httpd", "tracing", "stepprof", "slo",
    "goodput", "training", "runtime", "xstats", "numerics",
]
