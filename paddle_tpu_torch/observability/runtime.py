"""Runtime instrumentation feeding the registry (the port of
``paddle_tpu/observability/runtime.py``): compile events, live device
memory, profiler-span mirroring and the build's identity.

Everything here is install-on-demand and idempotent: importing this
module touches nothing heavy; ``install_all()`` (run by
``start_telemetry_server``) wires the probes:

- ``install_jax_monitoring`` (the reference's name, kept for its API
  surface): counts the port's compile events. The port runs eager
  PyTorch and compiles no program at run time; its one run-time compile
  is the kernel library's build (``ops/_build.py``, once per source
  hash), which becomes one ``paddle_jax_events_total{event=}`` event and
  one ``paddle_jax_event_duration_seconds{event=}`` sample of
  ``_build.build_seconds()``, also recorded in the goodput ledger's
  ``compile`` category, as the reference records XLA's compile time: into
  the default ledger if its run started before the build began (a build
  reported at install, before a ledger started, lies outside its
  accounting window);
- ``install_device_memory_collector``: a scrape-time collector setting
  ``paddle_device_memory_bytes{device=,stat=}`` from the caching
  allocator (``torch.cuda.memory_stats()``) and ``mem_get_info()`` for
  every CUDA device; nothing on a host without one;
- ``mirror_profiler_spans``: hooks the profiler's ``RecordEvent`` sink so
  every host span also lands in ``paddle_profiler_span_ms{span=}``;
- ``install_build_info``: the ``paddle_build_info`` info-gauge (the
  package, torch, CUDA and driver versions, the device's name, the kernel
  library's hash and python as labels on a constant 1).
"""
from __future__ import annotations

import threading
from typing import Optional

from .registry import MetricRegistry, default_registry

__all__ = [
    "install_jax_monitoring", "install_device_memory_collector",
    "mirror_profiler_spans", "install_build_info", "install_all",
    "KERNEL_BUILD_EVENT",
]

# the event name of the kernel library's build ("compil" in it routes the
# duration into the goodput ledger's compile category, as the reference's
# XLA compile events are routed)
KERNEL_BUILD_EVENT = "/paddle_tpu_torch/ops/kernel_library_compile"

_install_lock = threading.Lock()
_monitoring_installed = False


def install_jax_monitoring(registry: Optional[MetricRegistry] = None
                           ) -> bool:
    """Count the port's compile events (once per process): the kernel
    library's build, reported when it happens or at once if this process
    already built it. Returns True when the listener is live."""
    global _monitoring_installed
    with _install_lock:
        if _monitoring_installed:
            return True
        _monitoring_installed = True
    reg = registry or default_registry()
    events = reg.counter(
        "paddle_jax_events_total",
        "runtime compile events by name (the port's kernel library "
        "build)", ("event",))
    durations = reg.histogram(
        "paddle_jax_event_duration_seconds",
        "durations of timed runtime compile events (the kernel library's "
        "nvcc build)", ("event",),
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                 30.0, 60.0, 120.0))

    def _on_build(secs, started):
        events.labels(event=KERNEL_BUILD_EVENT).inc()
        durations.labels(event=KERNEL_BUILD_EVENT).observe(float(secs))
        # compile time is badput (the ledger's frame accounting claims
        # it from an enclosing step frame, so nothing double-counts)
        from .goodput import default_ledger
        ledger = default_ledger()
        t0 = ledger.started_at
        if t0 is not None and started is not None and t0 <= started:
            ledger.record("compile", float(secs))

    from ..ops import _build
    _build.add_build_listener(_on_build)
    return True


def process_start_unix() -> Optional[float]:
    """This process's start on the wall clock, from Linux's ``/proc`` (10
    ms resolution): the origin of a start-up split (the fleet worker's
    ``/readyz`` ``startup``, the elastic worker's ``STARTUP`` line).
    None where it cannot be read."""
    import os
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def startup_split(on_card: bool, start: Optional[float] = None) -> dict:
    """The first parts of a process's start-up split, in seconds:
    ``imports`` (from ``start``, by default the process's start, to this
    call: the interpreter and the imports), ``cuda_context`` (the CUDA
    context on the card) and ``kernel_library`` (loading, or building,
    the hand-written kernels' library). Without ``on_card`` the last two
    do nothing. The caller adds what follows (model, warmup, ...)."""
    import time
    t0 = process_start_unix() if start is None else start
    t = time.time()
    split = {"imports": round(t - t0, 4) if t0 is not None else None}
    if on_card:
        import torch
        torch.cuda.init()
        torch.empty(0, device="cuda")
        torch.cuda.synchronize()
    t1 = time.time()
    split["cuda_context"] = round(t1 - t, 4)
    if on_card:
        from ..ops import _build
        _build.load_library()
    split["kernel_library"] = round(time.time() - t1, 4)
    return split


def _device_label(index: int) -> str:
    return f"cuda:{index}"


def install_device_memory_collector(
        registry: Optional[MetricRegistry] = None) -> bool:
    """Scrape-time gauge of device memory per CUDA device: the caching
    allocator's ``allocated_bytes``/``reserved_bytes`` (current and peak)
    and the driver's free/total bytes. The reference's
    ``bytes_in_use``/``peak_bytes_in_use`` names carry the allocated
    series. Returns False on a host without CUDA."""
    import torch
    reg = registry or default_registry()
    gauge = reg.gauge(
        "paddle_device_memory_bytes",
        "device memory by device and stat (bytes_in_use / "
        "peak_bytes_in_use from the caching allocator's allocated bytes; "
        "reserved and the driver's free/total beside them)",
        ("device", "stat"))
    if not torch.cuda.is_available():
        return False

    def _collect(_reg):
        if not torch.cuda.is_initialized():
            return      # a scrape never initializes CUDA in this process
        for i in range(torch.cuda.device_count()):
            label = _device_label(i)
            st = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
            for stat, key in (
                    ("bytes_in_use", "allocated_bytes.all.current"),
                    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                    ("bytes_reserved", "reserved_bytes.all.current"),
                    ("peak_bytes_reserved", "reserved_bytes.all.peak")):
                gauge.labels(device=label, stat=stat).set(
                    int(st.get(key, 0)))
            gauge.labels(device=label, stat="bytes_free").set(int(free))
            gauge.labels(device=label, stat="bytes_limit").set(int(total))

    reg.register_collector(_collect, name="device_memory")
    return True


_span_histogram = None


def mirror_profiler_spans(enable: bool = True,
                          registry: Optional[MetricRegistry] = None
                          ) -> bool:
    """Route every profiler ``RecordEvent`` span duration into
    ``paddle_profiler_span_ms{span=}``, whether or not a profiler session
    is recording."""
    global _span_histogram
    from .. import profiler
    if not enable:
        profiler.set_span_sink(None)
        return False
    reg = registry or default_registry()
    _span_histogram = reg.histogram(
        "paddle_profiler_span_ms",
        "host-tracer RecordEvent span durations (serving::assemble, "
        "serving::dispatch, user spans, ...)", ("span",))

    def _sink(name, dur_ms):
        try:
            _span_histogram.labels(span=str(name)).observe(dur_ms)
        except Exception:  # noqa: BLE001
            pass

    profiler.set_span_sink(_sink)
    return True


def _driver_version() -> str:
    """The CUDA driver's version (``cuDriverGetVersion``, e.g. 12040), or
    'unknown' without a driver."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return str(v.value)
    except Exception:  # noqa: BLE001 - partial info beats no info
        pass
    return "unknown"


def install_build_info(registry: Optional[MetricRegistry] = None):
    """``paddle_build_info`` info-gauge (value 1; the labels carry the
    payload): package, torch, CUDA and driver versions, the device's
    name, the kernel library's hash, python. Returns the labels."""
    import platform

    import torch
    reg = registry or default_registry()
    labels = {"version": "unknown", "torch": str(torch.__version__),
              "cuda": str(torch.version.cuda or "none"),
              "driver": "none", "device": "cpu", "kernels": "unknown",
              "python": platform.python_version()}
    try:
        from .. import __version__
        labels["version"] = str(__version__)
    except Exception:  # noqa: BLE001
        pass
    try:
        if torch.cuda.is_available():
            labels["device"] = torch.cuda.get_device_name(0)
            labels["driver"] = _driver_version()
    except Exception:  # noqa: BLE001
        pass
    try:
        from ..ops import _build
        labels["kernels"] = _build.library_hash()
    except Exception:  # noqa: BLE001
        pass
    gauge = reg.gauge(
        "paddle_build_info",
        "build/runtime identity of this process (value 1; version, torch, "
        "cuda, driver, device, kernels (the kernel library's hash) and "
        "python ride the labels)",
        ("version", "torch", "cuda", "driver", "device", "kernels",
         "python"))
    gauge.clear()  # one identity per process: never two live children
    gauge.labels(**labels).set(1)
    return labels


def install_all(registry: Optional[MetricRegistry] = None):
    """Everything a telemetry endpoint carries by default. Profiler-span
    mirroring is opt-in through FLAGS_profiler_span_metrics."""
    install_jax_monitoring(registry)
    install_device_memory_collector(registry)
    install_build_info(registry)
    try:
        from ..framework.flags import flag_value
        if flag_value("FLAGS_profiler_span_metrics"):
            mirror_profiler_spans(True, registry)
    except Exception:  # noqa: BLE001
        pass
