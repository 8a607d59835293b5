"""Exporters: Chrome-trace/Perfetto events from a recorder snapshot, the
part of :mod:`mpit_tpu.obs.export` the flight recorder uses (the file
exporters and ``--trace`` are not ported yet).
"""

from __future__ import annotations

from typing import Any

__all__ = ["snapshot_trace_events"]


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
