"""Typed flag registry: the ``FLAGS_decode_*`` knobs the generation engine
reads and the ``FLAGS_serving_*`` knobs of the dynamic-batching server.

Counterpart of ``paddle_tpu/framework/flags.py`` (same surface:
``define_flag``/``flag_value``/``set_flags``, with a
``FLAGS_*`` environment variable overriding the default at definition
time). The port keeps its own registry: it imports nothing of
``paddle_tpu``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "flag_value", "set_flags", "get_flags",
           "flags_snapshot", "flags_generation"]


class _Flag:
    __slots__ = ("name", "value", "default", "type_", "help")

    def __init__(self, name, default, help_=""):
        self.name = name
        self.default = default
        self.type_ = type(default)
        self.help = help_
        env = os.environ.get(name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, s: str):
        if self.type_ is bool:
            return s.lower() in ("1", "true", "yes", "on")
        try:
            return self.type_(s)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"flag {self.name}: cannot parse {s!r} from environment "
                f"variable {self.name} as {self.type_.__name__} "
                f"(default: {self.default!r})") from e

    def set(self, v):
        if self.type_ is bool and isinstance(v, str):
            v = self._parse(v)
        try:
            self.value = self.type_(v)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"flag {self.name}: cannot coerce {v!r} to "
                f"{self.type_.__name__} (default: {self.default!r})") from e


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default, help_: str = ""):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    if name not in _REGISTRY:
        _REGISTRY[name] = _Flag(name, default, help_)
    return _REGISTRY[name]


def _key(name: str) -> str:
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {name!r}")
    return key


_GENERATION = 0


def flag_value(name: str):
    return _REGISTRY[_key(name)].value


def flags_generation() -> int:
    """A counter bumped by every ``set_flags`` call: readers on hot paths
    cache what they derive from flags and recompute when it moves."""
    return _GENERATION


def set_flags(flags: Dict[str, Any]) -> None:
    global _GENERATION
    try:
        for name, v in flags.items():
            _REGISTRY[_key(name)].set(v)
    finally:
        _GENERATION += 1


def get_flags(flags) -> Dict[str, Any]:
    """``paddle.get_flags``: ``{name: value}`` for a name or a list of
    names (unknown names raise)."""
    names = [flags] if isinstance(flags, str) else list(flags)
    return {_key(n): _REGISTRY[_key(n)].value for n in names}


def flags_snapshot() -> Dict[str, Dict[str, Any]]:
    """Every registered flag with its live value, default, type name and
    help text, by name (``paddle_tpu/framework/flags.py:110``)."""
    return {name: {"value": f.value, "default": f.default,
                   "type": f.type_.__name__, "help": f.help}
            for name, f in sorted(_REGISTRY.items())}


# The Paddle API's eager checks (core/dispatch.py), with the reference's
# name and default (paddle_tpu/framework/flags.py:122).
define_flag("FLAGS_check_nan_inf", False,
            "check outputs for nan/inf after every op")


# Decode serving knobs (serving/generation/engine.py), with the reference's
# names and defaults.
define_flag("FLAGS_decode_max_batch", 8,
            "in-flight decode batch width: one [max_batch, 1] decode step "
            "per iteration with dead lanes slot-masked")
define_flag("FLAGS_decode_page_size", 16,
            "tokens per KV-cache page of the per-layer pools")
define_flag("FLAGS_decode_kv_pages", 0,
            "total pages per layer pool incl. the reserved trash page "
            "(0 = auto: enough for max_batch sequences at max_seq_len, "
            "doubled for sub-f32 pools)")
define_flag("FLAGS_decode_queue_capacity", 64,
            "bounded generation request queue; submit_generate raises "
            "QueueFullError beyond this")
define_flag("FLAGS_decode_default_timeout_ms", 0.0,
            "scheduling deadline applied when submit_generate passes none "
            "(0 = no deadline); an expired request is dropped before "
            "prefill, never mid-stream")
define_flag("FLAGS_decode_prefix_cache", True,
            "shared-prefix KV reuse: keep finished sequences' FULL "
            "pages in a radix index keyed by token content, so a "
            "request whose prompt matches a cached prefix maps those "
            "pages into its block table (refcounted, copy-on-write at "
            "the divergence page) and prefills only its unique suffix; "
            "unreferenced cached pages are LRU-evicted under pool "
            "pressure")
define_flag("FLAGS_decode_spec_k", 0,
            "speculative decoding: tokens proposed per step by the "
            "draft model (GenerationServer(draft_model=...)); the "
            "target model verifies all k in one fixed-shape "
            "[max_batch, k+1] step with accept-and-resample, so "
            "output distribution matches non-speculative sampling "
            "(0 = off; ignored without a draft model)")
define_flag("FLAGS_decode_kv_dtype", "",
            "KV pool storage dtype for serving: '' = model dtype, "
            "'float32', 'bfloat16', or 'int8' (symmetric absmax "
            "quantization with per-slot-per-head f32 scales stored "
            "alongside the pools; quantize-on-write, dequantize-on-read "
            "in the paged kernel's row loads and in the plain gather). "
            "Auto pool sizing (FLAGS_decode_kv_pages=0) grants sub-f32 "
            "dtypes 2x pages. Read once at server construction")

# Serving knobs (serving/server.py, the dynamic-batching layer), with the
# reference's names and defaults (paddle_tpu/framework/flags.py:149-177, 243,
# 271, 398).
define_flag("FLAGS_serving_max_batch_size", 8,
            "rows coalesced into one device batch before dispatch")
define_flag("FLAGS_serving_max_wait_ms", 2.0,
            "coalescing window: a batch dispatches when full or this "
            "many ms after its oldest request, whichever first")
define_flag("FLAGS_serving_queue_capacity", 64,
            "bounded request queue; submit raises QueueFullError beyond "
            "this (backpressure)")
define_flag("FLAGS_serving_default_timeout_ms", 0.0,
            "per-request deadline applied when submit() passes none "
            "(0 = no deadline); expired requests are dropped unrun")
define_flag("FLAGS_serving_pad_batch_pow2", True,
            "pad coalesced batches up to power-of-two row buckets, so a "
            "server runs a bounded set of batch shapes")
define_flag("FLAGS_serving_capi_batching", False,
            "route C-ABI predictors through a shared InferenceServer "
            "(the C ABI waits for ROADMAP queue 1 item 5d)")
define_flag("FLAGS_serving_latency_window", 2048,
            "latency samples kept for the serving p50/p95/p99 metrics")
define_flag("FLAGS_serving_pipeline_depth", 2,
            "batches allowed in flight between dispatch and completion: "
            "the worker assembles batch N+1 while batch N computes on "
            "the device (0 = synchronous execute)")
define_flag("FLAGS_serving_telemetry_port", -1,
            "HTTP telemetry endpoint (/metrics /healthz /readyz /statusz "
            "/tracez /sloz /schedz) the InferenceServer and the "
            "GenerationServer attach on construction: -1 disabled, 0 "
            "ephemeral port, >0 fixed port; one shared endpoint per "
            "process")
define_flag("FLAGS_serving_donate_inputs", True,
            "accepted for the reference's surface and without effect: "
            "torch has no buffer donation, so the port always behaves as "
            "the reference does on its CPU backend, which does not "
            "donate (paddle_tpu/inference/__init__.py:683)")
define_flag("FLAGS_serving_mesh_mp", 1,
            "tensor-parallel degree of one serving replica; above 1 "
            "waits for ROADMAP queue 1 item 5c")
# The persistent compile cache (compile_cache/), with the reference's names
# and defaults (paddle_tpu/framework/flags.py:255-275).
define_flag("FLAGS_compile_cache_dir", "",
            "directory for the persistent compile cache (each signature's "
            "first-dispatch record, keyed by function/shape/flag/version "
            "fingerprints, and the warmup manifests); empty = disabled. A "
            "warm cache lets a restarted process skip the first-dispatch "
            "measurement at every wired site (TrainStep, the Predictor, "
            "the decoder) and replay its traffic's signatures before "
            "traffic. TRUSTED PATH ONLY: entries are unpickled on load, so "
            "a writer to this directory can execute code in every reader "
            "— it is created 0o700 and must never be shared or "
            "group-writable")
define_flag("FLAGS_compile_cache_max_bytes", 1 << 30,
            "size bound for FLAGS_compile_cache_dir: least-recently-"
            "used entries are evicted past this many bytes (0 = "
            "unbounded)")
define_flag("FLAGS_serving_warmup_from_manifest", False,
            "pre-warm a constructed InferenceServer from its persisted "
            "warmup manifest (the batch signatures a previous process's "
            "traffic dispatched) when one exists under "
            "FLAGS_compile_cache_dir — the restart-storm fast path")
define_flag("FLAGS_serving_ready_requires_warmup", False,
            "gate InferenceServer.ready on warmup: the server reports "
            "not-ready until warmup() completes (or mark_ready())")

# The operations plane (observability/{tracing,stepprof,slo}.py) and the
# multi-tenant scheduler (serving/scheduling/), with the reference's names
# and defaults (paddle_tpu/framework/flags.py:292-365, :481-499).
define_flag("FLAGS_goodput_tolerance", 0.02,
            "goodput_report() accounting tolerance: the report's 'closes' "
            "bit requires categories (incl. derived idle) to sum to "
            "elapsed wall-clock within this fraction")
define_flag("FLAGS_profiler_span_metrics", False,
            "mirror profiler RecordEvent span durations into the "
            "paddle_profiler_span_ms histogram so profiler traces and "
            "scraped /metrics agree")

# The runtime and numerics plane (observability/{runtime,xstats,numerics}
# .py), with the reference's names and defaults
# (paddle_tpu/framework/flags.py:281, 310-349, 377-390).
define_flag("FLAGS_xstats_enable", True,
            "populate the process-wide executable registry at the first "
            "dispatch of every signature (FLOPs, bytes and allocator "
            "memory per signature, the /execz page, and the "
            "paddle_mfu{kind=} join with the step profiler); off = every "
            "hook is a no-op")
define_flag("FLAGS_xstats_max_entries", 512,
            "bound of the executable registry: least-recently-registered "
            "entries are evicted past this many (counted in "
            "paddle_exec_evicted_total)")
define_flag("FLAGS_device_peak_flops", 0.0,
            "per-device peak FLOP/s for MFU and roofline computation; 0 = "
            "the built-in table keyed by the CUDA device's name (H100: "
            "dense bf16). No table entry pretends to know a host CPU's "
            "peak")
define_flag("FLAGS_device_peak_bytes_per_s", 0.0,
            "per-device peak memory bandwidth (bytes/s) for the bandwidth "
            "utilization gauge and the roofline ridge point; 0 = the "
            "built-in table, same contract as FLAGS_device_peak_flops")
define_flag("FLAGS_profile_dir", "",
            "directory of the bounded on-disk profile-capture ring "
            "(/profilez artifacts); empty = a per-process directory under "
            "the system temp dir")
define_flag("FLAGS_profile_ring", 8,
            "max retained capture artifacts in the /profilez ring (oldest "
            "artifact files are deleted past this)")
define_flag("FLAGS_profile_max_ms", 2000.0,
            "hard bound on one /profilez capture duration: a larger "
            "duration_ms query parameter is clamped here")
define_flag("FLAGS_profile_min_interval_s", 30.0,
            "rate limit between profile captures (manual or "
            "anomaly-triggered); captures inside the interval are refused "
            "and counted in paddle_profile_rate_limited_total")
define_flag("FLAGS_profile_on_anomaly", False,
            "arm anomaly-triggered capture: a stepprof straggler or a "
            "numerics anomaly starts one rate-limited background profile "
            "capture whose artifact records the anomaly span's trace id")
define_flag("FLAGS_profile_anomaly_ms", 500.0,
            "duration of an anomaly-triggered capture (bounded by "
            "FLAGS_profile_max_ms like every capture)")
define_flag("FLAGS_numerics_sample_rate", 0.0,
            "fraction of train/decode steps whose output health stats "
            "(finite fraction, max-abs, argmax-entropy, grad norm) are "
            "published; FLAGS_check_nan_inf=true overrides this to every "
            "step. The reductions run on the device and their host read "
            "is deferred one note, so sampling adds no device sync")
define_flag("FLAGS_numerics_shadow_rate", 0.0,
            "duty cycle of decode/chunked/verify shadow checks: a sampled "
            "dispatch is run again through the kernels' plain versions "
            "(use_kernels=False) on a copy of the pages it reads, and the "
            "max-abs logit divergence is published as "
            "paddle_numerics_shadow_divergence{kind,dtype}")

define_flag("FLAGS_stepprof_window", 512,
            "bound of the continuous step profiler's per-step envelope "
            "ring (oldest envelopes are evicted past this)")
define_flag("FLAGS_stepprof_anomaly_k", 6.0,
            "straggler threshold: a step slower than ewma + k * 1.4826 * "
            "MAD of its kind is flagged and promoted into the trace "
            "flight recorder as an error span")
define_flag("FLAGS_stepprof_min_samples", 32,
            "step samples per kind before the straggler detector arms "
            "(the EWMA/MAD baseline warm-up)")
define_flag("FLAGS_slo_eval_interval_s", 10.0,
            "cadence of the background SLO evaluator thread "
            "(SLOMonitor.start(); explicit evaluate() calls are always "
            "allowed)")
define_flag("FLAGS_trace_sample_rate", 0.0,
            "head-sampling rate for request traces (0 = tracing off, 1 = "
            "every request). The decision is made once at ingress, "
            "deterministically from the trace id; errored, shed and "
            "deadline requests are tail-promoted into the recorder "
            "regardless of the coin flip")
define_flag("FLAGS_trace_buffer_spans", 4096,
            "bound of the in-process span flight recorder (/tracez): "
            "oldest spans are evicted past this many")
define_flag("FLAGS_trace_max_spans_per_trace", 256,
            "per-trace span cap in the flight recorder and on the "
            "unsampled pending list, so one long decode stream cannot "
            "evict every other trace")
define_flag("FLAGS_sched_policy_file", "",
            "JSON tenant-policy file (rate/burst/weight/priority per "
            "tenant); hot-reloaded on mtime change. Empty = flags-only "
            "policy")
define_flag("FLAGS_sched_default_rate", 0.0,
            "default tenant token-bucket refill rate in tokens/s "
            "(admission cost is the request's rows at the InferenceServer, "
            "prompt+max_new tokens at the generation engine); 0 = "
            "unlimited")
define_flag("FLAGS_sched_default_burst", 64.0,
            "default tenant token-bucket depth (burst allowance)")
define_flag("FLAGS_sched_default_weight", 1.0,
            "default tenant weighted-fair-queuing weight (a weight-4 "
            "tenant drains 4x the token volume of a weight-1 tenant under "
            "contention)")
define_flag("FLAGS_sched_default_priority", "standard",
            "default tenant priority class: realtime | standard | batch "
            "(admission prefers realtime; page-pressure preemption parks "
            "batch first and never touches a higher class)")


# The serving fleet (serving/fleet/: supervisor, replica workers, router,
# resilience) and its autoscaler (serving/scheduling/autoscaler.py), with
# the reference's names and defaults (paddle_tpu/framework/flags.py:396-480,
# :503-522).
define_flag("FLAGS_fleet_replicas", 2,
            "default replica count a ReplicaSupervisor spawns when the "
            "caller does not pass one")
define_flag("FLAGS_fleet_retries", 2,
            "router retry budget per batch: a dispatch shed with "
            "QueueFullError (HTTP 429) or refused by a not-ready "
            "replica is retried on another replica this many times "
            "before the batch fails with QueueFullError")
define_flag("FLAGS_fleet_health_interval_ms", 200.0,
            "router readiness-poll cadence: every interval each known "
            "replica's /readyz is probed and the routable set updated")
define_flag("FLAGS_fleet_restart_backoff_ms", 200.0,
            "supervisor respawn backoff after a replica process exits "
            "unexpectedly (doubles per consecutive crash of the same "
            "replica, capped at 30x)")
define_flag("FLAGS_fleet_request_timeout_s", 120.0,
            "router-side HTTP timeout for one forwarded batch or "
            "generation stream read; a replica that blows it fails "
            "only the in-flight requests riding that connection")
define_flag("FLAGS_fleet_drain_timeout_s", 30.0,
            "rolling-swap drain bound: max seconds swap_weights waits "
            "for one draining replica's outstanding requests to reach "
            "zero before the swap aborts (remaining replicas keep the "
            "old weights — never a half-broken fleet)")
define_flag("FLAGS_fleet_retry_backoff_ms", 10.0,
            "base of the router's exponential retry backoff: retry N "
            "sleeps uniform[0, min(cap, base * 2^N)] (full jitter, so "
            "a fleet-wide brownout does not trigger a synchronized "
            "retry storm); 0 = immediate retries (the pre-resilience "
            "behavior)")
define_flag("FLAGS_fleet_retry_backoff_max_ms", 500.0,
            "cap of the router's exponential retry backoff sleep")
define_flag("FLAGS_fleet_breaker_window", 16,
            "per-replica circuit-breaker rolling outcome window: the "
            "last N dispatch outcomes drive the open/close decision")
define_flag("FLAGS_fleet_breaker_failure_ratio", 0.5,
            "circuit-breaker open threshold: the breaker opens when "
            "failures / window samples reaches this ratio (with at "
            "least FLAGS_fleet_breaker_min_samples outcomes seen)")
define_flag("FLAGS_fleet_breaker_min_samples", 4,
            "minimum outcomes in the rolling window before the "
            "failure ratio can open a breaker (no opening on the "
            "first blip)")
define_flag("FLAGS_fleet_breaker_open_ms", 1000.0,
            "circuit-breaker cooldown: an open breaker sheds all "
            "traffic from its replica for this long, then moves to "
            "half-open and admits ONE probe request; the probe's "
            "outcome closes or re-opens it")
define_flag("FLAGS_fleet_breaker_latency_ms", 0.0,
            "slow-but-alive threshold: a SUCCESSFUL dispatch slower "
            "than this counts as a breaker failure, so a replica "
            "serving 100x latency while /readyz-green still gets "
            "drained (0 = latency never trips the breaker)")
define_flag("FLAGS_fleet_hedge_ms", 0.0,
            "request hedging floor: when a submit/submit_many "
            "dispatch is still pending after max(this, the replica "
            "latency window's FLAGS_fleet_hedge_quantile), a hedge "
            "fires to a SECOND replica and the first response wins "
            "(idempotent batch path only — submit_generate never "
            "hedges); 0 = hedging off")
define_flag("FLAGS_fleet_hedge_quantile", 0.95,
            "latency quantile of the primary replica's rolling window "
            "used as the adaptive hedge trigger (bounded below by "
            "FLAGS_fleet_hedge_ms)")
define_flag("FLAGS_fleet_wedge_timeout_ms", 0.0,
            "device-wedge watchdog: a worker dispatch in flight "
            "longer than this flips /readyz to not-ready, fails "
            "waiting requests with ReplicaWedgedError and asks the "
            "supervisor for a restart (worker processes exit; the "
            "respawn is a warm start). 0 = watchdog off")
define_flag("FLAGS_autoscale_min_replicas", 1,
            "autoscaler floor: never scale the fleet below this")
define_flag("FLAGS_autoscale_max_replicas", 8,
            "autoscaler ceiling: never scale the fleet above this")
define_flag("FLAGS_autoscale_cooldown_s", 30.0,
            "minimum seconds between scale actions in either "
            "direction (hysteresis against flapping)")
define_flag("FLAGS_autoscale_scale_in_quiet_s", 120.0,
            "scale IN only after this long with no burn-rate rule "
            "firing and queue/occupancy low (asymmetric hysteresis: "
            "out fast, in slow)")
define_flag("FLAGS_autoscale_queue_high", 16.0,
            "router/worker queue depth above which the autoscaler "
            "scales out")
define_flag("FLAGS_autoscale_occupancy_high", 0.85,
            "decode-slot occupancy fraction above which the "
            "autoscaler scales out")
define_flag("FLAGS_autoscale_interval_s", 5.0,
            "autoscaler control-loop evaluation period in seconds")
define_flag("FLAGS_numerics_canary_period_s", 0.0,
            "period of the per-worker deterministic checksum canary "
            "sweep (SDC detection); 0 disables. The sweep also runs "
            "on not-ready -> ready transitions; a failing canary "
            "quarantines the replica (readiness flip + breaker open)")

# Elastic training (elastic/manager.py, elastic/preemption.py), with the
# reference's names and defaults (paddle_tpu/elastic/manager.py:66-86,
# paddle_tpu/elastic/preemption.py:33-40).
define_flag("FLAGS_ckpt_keep", 3,
            "checkpoints retained per directory (mtime-LRU: the oldest "
            "beyond this many committed checkpoints are deleted after "
            "each successful save; <= 0 keeps everything)")
define_flag("FLAGS_ckpt_interval_steps", 0,
            "CheckpointManager.step() saves every this many steps "
            "(0 = no step-based cadence)")
define_flag("FLAGS_ckpt_interval_s", 0.0,
            "CheckpointManager.step() saves when this many seconds "
            "passed since the last save attempt (0 = no wall-clock "
            "cadence)")
define_flag("FLAGS_ckpt_async", True,
            "stage+commit checkpoint writes on a background thread "
            "(the device->host snapshot is always synchronous, so in-place "
            "updates after the call never corrupt the checkpoint); off = "
            "fully synchronous saves")
define_flag("FLAGS_ckpt_staleness_s", 0.0,
            "checkpoint /healthz staleness threshold: unhealthy when the "
            "last committed checkpoint is older than this many seconds "
            "(0 = auto: 3x FLAGS_ckpt_interval_s when set, else 1800)")
define_flag("FLAGS_ckpt_preempt_deadline_s", 30.0,
            "grace budget for the preemption-triggered final checkpoint "
            "save, counted from the signal: the save waits for the next "
            "step boundary (at most half of it), then at most the rest for "
            "the save to commit before chaining to the previous handler "
            "(a commit that misses the window is a torn staging directory "
            "the next restore ignores)")
