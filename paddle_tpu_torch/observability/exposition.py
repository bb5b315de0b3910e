"""Render a MetricRegistry for scraping (the port of
``paddle_tpu/observability/exposition.py``): Prometheus text format 0.0.4
and a JSON mirror of the same samples (the JSON also carries the
bounded-window percentiles that Prometheus histograms cannot express)."""
from __future__ import annotations

import json
import math
from typing import Optional

from .registry import (Counter, Gauge, Histogram, MetricRegistry,
                       default_registry)

__all__ = ["prometheus_text", "json_snapshot", "json_text",
           "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def prometheus_text(registry: Optional[MetricRegistry] = None) -> str:
    registry = registry or default_registry()
    lines = []
    for fam in registry.collect():
        children = fam.collect()
        if not children:
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, Histogram):
            for labels, child in children:
                for ub, cum in child.buckets():
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(labels, {'le': _fmt_value(ub)})} "
                        f"{cum}")
                lines.append(f"{fam.name}_sum{_labels_str(labels)} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{_labels_str(labels)} "
                             f"{child.count}")
        elif isinstance(fam, (Counter, Gauge)):
            for labels, child in children:
                lines.append(f"{fam.name}{_labels_str(labels)} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(registry: Optional[MetricRegistry] = None) -> dict:
    registry = registry or default_registry()
    out = {}
    for fam in registry.collect():
        samples = []
        if isinstance(fam, Histogram):
            for labels, child in fam.collect():
                samples.append({
                    "labels": labels,
                    "count": child.count,
                    "sum": child.sum,
                    "buckets": {_fmt_value(ub): cum
                                for ub, cum in child.buckets()},
                    "window": child.window_snapshot(),
                })
        else:
            for labels, child in fam.collect():
                v = child.value
                if isinstance(v, float) and (math.isnan(v)
                                             or math.isinf(v)):
                    v = None
                samples.append({"labels": labels, "value": v})
        out[fam.name] = {"type": fam.kind, "help": fam.help,
                         "samples": samples}
    return out


def json_text(registry: Optional[MetricRegistry] = None,
              indent: Optional[int] = None) -> str:
    return json.dumps(json_snapshot(registry), indent=indent,
                      sort_keys=True)
