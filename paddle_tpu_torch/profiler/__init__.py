"""Profiler markers of the port: ``RecordEvent`` (the port of
``paddle_tpu/profiler/__init__.py:136``) over
``torch.profiler.record_function``, so a span shows in a torch.profiler
trace beside the CUDA kernels it launched. The reference's host tracer,
scheduler and chrome export wait for ROADMAP queue 1 item 5d."""
from __future__ import annotations

import torch

__all__ = ["RecordEvent"]


class RecordEvent:
    """Span marker usable as a context manager or a ``begin``/``end``
    pair. ``args`` (a shallow dict, e.g. the serving layer's
    ``{"rows": 8, "padded": 8}``) can be extended during the span with
    ``set_arg``."""

    def __init__(self, name, event_type=None, args=None):
        self.name = name
        self.args = dict(args) if args else None
        self._handle = None

    def set_arg(self, key, value):
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def begin(self):
        self._handle = torch.profiler.record_function(self.name)
        self._handle.__enter__()

    def end(self):
        if self._handle is not None:
            self._handle.__exit__(None, None, None)
            self._handle = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False
