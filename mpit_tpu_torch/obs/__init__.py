"""Observability of the port: spans, counters and gauges
(:mod:`mpit_tpu_torch.obs.core`)."""

from mpit_tpu_torch.obs.core import (
    Recorder,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    span,
    span_at,
    summary,
)

__all__ = [
    "Recorder",
    "counter",
    "disable",
    "enable",
    "enabled",
    "gauge",
    "span",
    "span_at",
    "summary",
]
