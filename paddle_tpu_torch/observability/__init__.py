"""Observability of the port: the metric registry (``registry.py``) and
request tracing (``tracing.py``), the parts that the serving layer reports
into. The HTTP telemetry endpoint, goodput, SLO and step profiles wait for
ROADMAP queue 1 item 5b."""
from . import registry, tracing  # noqa: F401

__all__ = ["registry", "tracing"]
