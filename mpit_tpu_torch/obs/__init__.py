"""Observability of the port: spans, instants, counters and gauges
(:mod:`mpit_tpu_torch.obs.core`), per-thread recorders for compat rank
threads, streaming windowed metrics (:mod:`~mpit_tpu_torch.obs.stream`),
the request ledger (:mod:`~mpit_tpu_torch.obs.trace`) and the cross-rank
flight recorder (:mod:`~mpit_tpu_torch.obs.aggregate`)."""

from mpit_tpu_torch.obs.core import (
    Recorder,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    get_global_recorder,
    get_recorder,
    instant,
    local_recorder,
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
    "get_global_recorder",
    "get_recorder",
    "instant",
    "local_recorder",
    "span",
    "span_at",
    "summary",
]
