"""``paddle.device``: the port of ``paddle_tpu/device/__init__.py`` over
``torch.cuda``.

Streams and events are CUDA's (``Stream``, ``Event``, ``current_stream``,
``set_stream``, ``stream_guard``); the memory statistics are the caching
allocator's (0 without a GPU). ``CUDAGraph``, ``wrap_cuda_graph``,
``is_cuda_graph_supported`` and ``graphs`` keep the reference's call
protocol and answers: nothing is captured, a wrapped function is returned
as it is, and graphs are not supported (real capture is ROADMAP 2c's
work). The other hardware's ``is_compiled_with_*`` names answer False and
there are no custom devices, as on the reference.
"""
import contextlib
import types as _types

import torch

from ..framework.device import (device_count, get_device,  # noqa: F401
                                is_compiled_with_cuda, is_compiled_with_rocm,
                                is_compiled_with_tpu, is_compiled_with_xpu,
                                set_device, synchronize)
from ..framework.place import (CPUPlace, CUDAPlace, NPUPlace,  # noqa: F401
                               Place, TPUPlace, XPUPlace)


def get_all_device_type():
    return ["cpu", "gpu"]


def get_available_device():
    out = ["cpu"]
    if torch.cuda.is_available():
        out += [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return out


def _cuda_device(device):
    if device is None or isinstance(device, int):
        return device
    if isinstance(device, Place):
        return device.torch_device()
    return str(device).replace("gpu", "cuda")


class Stream:
    """A CUDA stream (``priority`` 1 high, 2 normal, as Paddle's)."""

    def __init__(self, device=None, priority=2, stream_base=None):
        self._s = stream_base if stream_base is not None else \
            torch.cuda.Stream(_cuda_device(device),
                              priority=-1 if priority == 1 else 0)
        self.device = self._s.device

    @property
    def cuda_stream(self):
        return self._s.cuda_stream

    def synchronize(self):
        self._s.synchronize()

    def query(self):
        return self._s.query()

    def wait_stream(self, stream):
        self._s.wait_stream(stream._s)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event):
        self._s.wait_event(event._e)


class Event:
    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._e = torch.cuda.Event(enable_timing=enable_timing,
                                   blocking=blocking,
                                   interprocess=interprocess)

    def record(self, stream=None):
        self._e.record(None if stream is None else stream._s)

    def query(self):
        return self._e.query()

    def synchronize(self):
        self._e.synchronize()

    def elapsed_time(self, end_event):
        return self._e.elapsed_time(end_event._e)


def current_stream(device=None):
    return Stream(stream_base=torch.cuda.current_stream(
        _cuda_device(device)))


def set_stream(stream):
    """Make ``stream`` current; returns the stream it replaces."""
    prev = current_stream()
    torch.cuda.set_stream(stream._s)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(None if stream is None else stream._s):
        yield


def _stat(fn, device):
    return fn(_cuda_device(device)) if torch.cuda.is_available() else 0


def memory_allocated(device=None):
    return _stat(torch.cuda.memory_allocated, device)


def max_memory_allocated(device=None):
    return _stat(torch.cuda.max_memory_allocated, device)


def memory_reserved(device=None):
    return _stat(torch.cuda.memory_reserved, device)


def max_memory_reserved(device=None):
    return _stat(torch.cuda.max_memory_reserved, device)


def reset_peak_memory_stats(device=None):
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(_cuda_device(device))


def empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class CUDAGraph:
    """The reference's graph object: ``capture_begin``/``capture_end``
    record nothing and ``replay`` runs nothing (a replay before a capture
    raises, as there)."""

    def __init__(self, place=None, mode="thread_local"):
        self._captured = False

    def capture_begin(self):
        self._captured = True

    def capture_end(self):
        pass

    def replay(self):
        if not self._captured:
            raise RuntimeError("CUDAGraph.replay() before capture")

    def reset(self):
        self._captured = False

    def print_to_dot_files(self, dirname, flags=None):
        pass


def wrap_cuda_graph(function, mode="thread_local", memory_pool="default"):
    """Returns ``function`` as it is (no capture)."""
    return function


def is_cuda_graph_supported():
    return False


graphs = _types.SimpleNamespace(
    CUDAGraph=CUDAGraph, wrap_cuda_graph=wrap_cuda_graph,
    is_cuda_graph_supported=is_cuda_graph_supported)

cuda = _types.SimpleNamespace(
    Stream=Stream, Event=Event, current_stream=current_stream,
    stream_guard=stream_guard, synchronize=synchronize,
    device_count=lambda: device_count("gpu"),
    max_memory_allocated=max_memory_allocated,
    max_memory_reserved=max_memory_reserved,
    memory_allocated=memory_allocated, memory_reserved=memory_reserved,
    empty_cache=empty_cache,
    get_device_properties=lambda device=None: torch.cuda.
    get_device_properties(_cuda_device(device) or 0),
    graphs=graphs)


def get_cudnn_version():
    """cuDNN's version as an int, None without cuDNN (the reference's
    contract)."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_ipu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_custom_device(device_type):
    return False


def get_all_custom_device_type():
    return []


def get_available_custom_device():
    return []
