"""Observability of the port (the port of :mod:`mpit_tpu.obs`).

- spans, instants, counters and gauges into a process-global
  :class:`~mpit_tpu_torch.obs.core.Recorder`, or a thread-local one
  (:func:`local_recorder`) for compat rank threads; near-zero cost while
  disabled; :func:`summary` and :func:`gap_attribution` roll them up;
- exporters: :func:`export_chrome_trace` (Perfetto / ``chrome://tracing``),
  :func:`export_jsonl` (the metrics stream's record shape) and
  :func:`traffic_matrix` (the compat simulator's rank x rank bytes);
- :mod:`~mpit_tpu_torch.obs.stream` — bounded-memory windowed
  histograms, rates and gauges; :mod:`~mpit_tpu_torch.obs.slo` —
  declarative SLO targets evaluated over them (:class:`SLOMonitor`);
- :class:`Sentinel` — the median/MAD anomaly detector over phase times;
- :mod:`~mpit_tpu_torch.obs.roofline` — modeled work against measured
  span seconds, as shares of the card's peaks (percentages only on a
  known card); build observability (``CompileWatch``);
- :mod:`~mpit_tpu_torch.obs.memledger` — the byte-exact device-memory
  ledger (:class:`MemLedger`), reconciled on the card against
  ``torch.cuda.memory_allocated``;
- :mod:`~mpit_tpu_torch.obs.trace` — the request lifecycle ledger
  (:class:`Ledger`), tail exemplars and the why-slow attribution;
- :mod:`~mpit_tpu_torch.obs.baseline` — phase snapshots and the
  regression gate;
- :mod:`~mpit_tpu_torch.obs.aggregate` — the cross-rank flight recorder
  over compat rank threads.

``python -m mpit_tpu_torch.obs summary|diff|why-slow|capacity`` reads
what those wrote.
"""

from mpit_tpu_torch.obs import (
    aggregate,
    baseline,
    memledger,
    roofline,
    slo,
    stream,
    trace,
)
from mpit_tpu_torch.obs.core import (
    Recorder,
    counter,
    disable,
    enable,
    enabled,
    gap_attribution,
    gauge,
    get_global_recorder,
    get_recorder,
    instant,
    local_recorder,
    span,
    span_at,
    summary,
)
from mpit_tpu_torch.obs.export import (
    chrome_trace_events,
    export_chrome_trace,
    export_jsonl,
    snapshot_trace_events,
    traffic_matrix,
)
from mpit_tpu_torch.obs.memledger import MemLedger
from mpit_tpu_torch.obs.sentinel import Sentinel
from mpit_tpu_torch.obs.slo import SLO, SLOMonitor
from mpit_tpu_torch.obs.stream import HistogramSketch, StreamRegistry
from mpit_tpu_torch.obs.trace import Ledger, TraceContext

__all__ = [
    "HistogramSketch",
    "Ledger",
    "MemLedger",
    "Recorder",
    "SLO",
    "SLOMonitor",
    "Sentinel",
    "StreamRegistry",
    "TraceContext",
    "aggregate",
    "baseline",
    "chrome_trace_events",
    "counter",
    "disable",
    "enable",
    "enabled",
    "export_chrome_trace",
    "export_jsonl",
    "gap_attribution",
    "gauge",
    "get_global_recorder",
    "get_recorder",
    "instant",
    "local_recorder",
    "memledger",
    "roofline",
    "slo",
    "snapshot_trace_events",
    "span",
    "span_at",
    "stream",
    "summary",
    "trace",
    "traffic_matrix",
]
