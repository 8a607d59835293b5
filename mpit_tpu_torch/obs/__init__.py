"""Observability of the port: spans, instants, counters and gauges
(:mod:`mpit_tpu_torch.obs.core`)."""

from mpit_tpu_torch.obs.core import (
    Recorder,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    instant,
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
    "instant",
    "span",
    "span_at",
    "summary",
]
