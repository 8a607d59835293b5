"""Exporters: Chrome-trace/Perfetto JSON, MetricLogger-shaped JSONL, and
the compat simulator's rank x rank traffic matrix (the port of
:mod:`mpit_tpu.obs.export`).

The Chrome trace complements the ``torch.profiler`` capture of
:func:`mpit_tpu_torch.utils.profiling.trace`: the profiler sees the
kernels on the card; this timeline sees where the run's host wall goes
(prefill and decode ticks, request intervals, prefetch waits, fences,
checkpoints) and the instants (anomalies, SLO breaches) beside them.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any

import numpy as np

from mpit_tpu_torch.obs import core

__all__ = [
    "chrome_trace_events",
    "export_chrome_trace",
    "export_jsonl",
    "snapshot_trace_events",
    "traffic_matrix",
]


def _require(recorder: core.Recorder | None) -> core.Recorder:
    rec = recorder or core.get_recorder()
    if rec is None:
        raise RuntimeError(
            "obs is disabled and no recorder was passed — call "
            "obs.enable() before the run, or pass the Recorder explicitly"
        )
    return rec


def chrome_trace_events(
    recorder: core.Recorder | None = None, *, pid: int = 0
) -> list[dict]:
    """The ``traceEvents`` list (Chrome trace event format): spans as
    complete ("X") events, instants "i", one "C" sample per counter
    series, thread-name metadata ("M") rows; timestamps in µs since the
    recorder's epoch. ``pid``: the process lane (0: the port runs one
    process per card)."""
    return snapshot_trace_events(_require(recorder).snapshot(), pid=pid)


def snapshot_trace_events(
    snap: dict, *, pid: int = 0, pid_label: str | None = None
) -> list[dict]:
    """Chrome-trace events from a :meth:`Recorder.snapshot`/``drain`` dict.

    The snapshot-shaped entry point exists for the distributed flight
    recorder: rank snapshots shipped to rank 0 are plain dicts
    (the Recorder object stays on its rank), and the merged trace gives
    each rank its own ``pid`` so Perfetto renders one LANE PER RANK.
    ``pid_label`` adds the process_name metadata row naming the lane.
    """
    events: list[dict] = []
    if pid_label:
        events.append(
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": pid_label}}
        )
    for tid, name in sorted(snap["thread_names"].items()):
        events.append(
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": name}}
        )
    last_ts = 0.0
    for kind, name, t0, dur, tid, attrs in snap["events"]:
        ev: dict[str, Any] = {
            "ph": kind,
            "name": name,
            "cat": "obs",
            "pid": pid,
            "tid": tid,
            "ts": round(t0 * 1e6, 3),
        }
        if kind == "X":
            ev["dur"] = round(dur * 1e6, 3)
        if kind == "i":
            ev["s"] = "t"  # instant scope: thread
        if attrs:
            ev["args"] = dict(attrs)
        events.append(ev)
        last_ts = max(last_ts, (t0 + dur) * 1e6)
    # One "C" sample per counter series at the end of the trace — the
    # accumulated totals, attribute sets as separate series.
    for (name, akey), value in sorted(snap["counters"].items()):
        label = name if not akey else (
            name + "{" + ",".join(f"{k}={v}" for k, v in akey) + "}"
        )
        events.append(
            {"ph": "C", "name": label, "pid": pid, "ts": round(last_ts, 3),
             "args": {"value": value}}
        )
    return events


def export_chrome_trace(
    path: str | Path, recorder: core.Recorder | None = None,
    *, extra_events: list[dict] | None = None,
) -> Path:
    """Write a Perfetto-loadable Chrome-trace JSON file (atomically) and
    return its path. ``extra_events``: Chrome-format rows appended after
    the recorder's own (the request ledger's exemplar instants,
    :func:`mpit_tpu_torch.obs.trace.exemplar_trace_events`). A recorder
    that dropped events marks the file ``dropped_events`` and warns on
    stderr: the file is a truncated trace."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # One snapshot feeds both the events and the dropped count.
    snap = _require(recorder).snapshot()
    doc = {
        "traceEvents": snapshot_trace_events(snap) + list(extra_events or ()),
        "displayTimeUnit": "ms",
    }
    dropped = snap["dropped"]
    if dropped:
        doc["dropped_events"] = dropped
        print(
            f"obs: WARNING: recorder dropped {dropped} events "
            f"(max_events hit) — {path} is a truncated trace",
            file=sys.stderr,
        )
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    tmp.replace(path)
    return path


def export_jsonl(path: str | Path, recorder: core.Recorder | None = None) -> Path:
    """Write one MetricLogger-shaped record per event, then one per
    counter and gauge series (``{"step": i, ...}``, ``step`` the record's
    index), through :class:`mpit_tpu_torch.train.metrics.MetricLogger`,
    so one parser reads this stream and the metrics stream."""
    from mpit_tpu_torch.train.metrics import MetricLogger

    snap = _require(recorder).snapshot()
    path = Path(path)
    logger = MetricLogger(path, stdout=False)
    try:
        i = 0
        for kind, name, t0, dur, _tid, attrs in snap["events"]:
            record = {"event": "span" if kind == "X" else "instant",
                      "name": name, "t0_s": round(t0, 6), "dur_s": round(dur, 6)}
            if attrs:
                # Attributes never overwrite the record's fields or "step".
                record.update({k: v for k, v in attrs.items()
                               if k not in record and k != "step"})
            logger.log(i, record)
            i += 1
        for kind, series in (("counter", snap["counters"]), ("gauge", snap["gauges"])):
            for (name, akey), value in sorted(series.items()):
                record = {"event": kind, "name": name, "value": value}
                record.update({k: v for k, v in akey if k not in record and k != "step"})
                logger.log(i, record)
                i += 1
    finally:
        logger.close()
    return path


def traffic_matrix(
    nranks: int | None = None,
    recorder: core.Recorder | None = None,
    *,
    counter: str = "p2p_send_bytes",
) -> np.ndarray:
    """Rank x rank byte matrix from the compat simulator's P2P counters:
    ``M[src, dst]`` = bytes ``src`` sent ``dst``. ``nranks`` defaults to
    1 + the largest rank seen."""
    items = list(_require(recorder).counter_items(counter))
    if nranks is None:
        nranks = 1 + max(
            (max(int(a["src"]), int(a["dst"])) for a, _ in items), default=-1
        )
    m = np.zeros((nranks, nranks), dtype=np.float64)
    for attrs, value in items:
        src, dst = int(attrs["src"]), int(attrs["dst"])
        if src < nranks and dst < nranks:
            m[src, dst] += value
    return m
