"""Event core: spans, counters, gauges and the process-global Recorder.

A standard-library copy of the part of :mod:`mpit_tpu.obs.core` the
serving scheduler uses. Every primitive is one module-global read when
no recorder is installed: :func:`span` then returns a shared no-op
context manager, so instrumentation costs nothing until :func:`enable`.

- a *span* is ``("X", name, t0, dur, tid, attrs)``, a named wall-clock
  interval on a thread (``t0`` in seconds since the recorder's epoch);
  an *instant* is ``("i", name, t, 0.0, tid, attrs)``, a marker;
- *counters* accumulate floats keyed by ``(name, attrs)``; *gauges*
  keep the last value.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

__all__ = [
    "Recorder",
    "counter",
    "disable",
    "enable",
    "enabled",
    "gauge",
    "instant",
    "phase_stats",
    "span",
    "span_at",
    "summary",
]


def _attr_key(attrs: Mapping[str, Any] | None) -> tuple:
    """Canonical hashable key for an attribute set."""
    if not attrs:
        return ()
    return tuple(sorted(attrs.items()))


def phase_stats(durations: Mapping[str, Any]) -> dict:
    """``{name: {count, total_s, p50_s, p95_s}}`` from per-phase
    duration lists."""
    import numpy as np

    phases = {}
    for name, durs in sorted(durations.items()):
        arr = np.asarray(durs)
        phases[name] = {
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
    return phases


class Recorder:
    """Thread-safe in-memory event buffer. Events past ``max_events``
    are dropped and counted, never buffered without bound."""

    def __init__(self, *, max_events: int = 2_000_000):
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._max_events = max_events
        self.dropped = 0
        # (kind, name, t0_s, dur_s, tid, attrs | None); kind "X" = span,
        # "i" = instant
        self.events: list[tuple] = []
        self.counters: dict[tuple[str, tuple], float] = {}
        self.gauges: dict[tuple[str, tuple], float] = {}

    def _add_event(self, event: tuple) -> None:
        with self._lock:
            if len(self.events) >= self._max_events:
                self.dropped += 1
                return
            self.events.append(event)

    def add_span(
        self, name: str, t0: float, t1: float, attrs: Mapping | None = None
    ) -> None:
        self._add_event(
            ("X", name, t0 - self._epoch, t1 - t0, threading.get_ident(), attrs)
        )

    def add_instant(self, name: str, attrs: Mapping | None = None) -> None:
        t = time.perf_counter() - self._epoch
        self._add_event(("i", name, t, 0.0, threading.get_ident(), attrs))

    def add_counter(
        self, name: str, value: float, attrs: Mapping | None = None
    ) -> None:
        key = (name, _attr_key(attrs))
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def add_gauge(
        self, name: str, value: float, attrs: Mapping | None = None
    ) -> None:
        with self._lock:
            self.gauges[(name, _attr_key(attrs))] = float(value)

    def snapshot(self) -> dict:
        """Consistent copy of all buffers."""
        with self._lock:
            return {
                "events": list(self.events),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "dropped": self.dropped,
            }

    def summary(self) -> dict:
        """``{"phases": {name: {count, total_s, p50_s, p95_s[, labels]}},
        "counters": {name: total}[, "instants": {name: count}],
        "dropped_events": n}``. String span attributes are mode labels
        (e.g. ``attention="kernel"``): their distinct values roll up under
        the phase's ``labels``."""
        snap = self.snapshot()
        by_name: dict[str, list[float]] = {}
        labels: dict[str, dict[str, set]] = {}
        instants: dict[str, int] = {}
        for kind, name, _t0, dur, _tid, attrs in snap["events"]:
            if kind == "i":
                instants[name] = instants.get(name, 0) + 1
                continue
            by_name.setdefault(name, []).append(dur)
            for k, v in (attrs or {}).items():
                if isinstance(v, str):
                    labels.setdefault(name, {}).setdefault(k, set()).add(v)
        phases = phase_stats(by_name)
        for name, lab in labels.items():
            phases[name]["labels"] = {k: sorted(vs) for k, vs in lab.items()}
        counters: dict[str, float] = {}
        for (name, _akey), v in snap["counters"].items():
            counters[name] = counters.get(name, 0.0) + v
        out = {"phases": phases, "counters": counters}
        if instants:
            out["instants"] = dict(sorted(instants.items()))
        out["dropped_events"] = snap["dropped"]
        return out


# ---------------------------------------------------------------------------
# Process-global switch + the primitives library code calls.
# ---------------------------------------------------------------------------

_RECORDER: Recorder | None = None
_LOCK = threading.Lock()


class _NoopSpan:
    """Shared do-nothing context manager: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """Live span: times ``__enter__``..``__exit__`` and records on exit
    into whichever recorder is installed then."""

    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Mapping | None):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = _RECORDER
        if rec is not None:
            rec.add_span(self.name, self.t0, time.perf_counter(), self.attrs)
        return False


def enable(recorder: Recorder | None = None) -> Recorder:
    """Install (and return) the process-global recorder. Idempotent when
    one is already installed and none is passed."""
    global _RECORDER
    with _LOCK:
        if recorder is not None:
            _RECORDER = recorder
        elif _RECORDER is None:
            _RECORDER = Recorder()
        return _RECORDER


def disable() -> None:
    """Remove the process-global recorder; the primitives return to the
    no-op fast path. The recorder keeps its events for the caller."""
    global _RECORDER
    with _LOCK:
        _RECORDER = None


def enabled() -> bool:
    return _RECORDER is not None


def span(name: str, **attrs):
    """Context manager timing a named phase."""
    if _RECORDER is None:
        return _NOOP
    return _Span(name, attrs or None)


def span_at(name: str, t0: float, t1: float, **attrs) -> None:
    """Record a completed span from explicit ``time.perf_counter``
    timestamps: the per-request ``queue_wait`` / ``request_ttft`` /
    ``request_latency`` intervals span many loop ticks."""
    rec = _RECORDER
    if rec is not None:
        rec.add_span(name, t0, t1, attrs or None)


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event."""
    rec = _RECORDER
    if rec is not None:
        rec.add_instant(name, attrs or None)


def counter(name: str, value: float = 1.0, **attrs) -> None:
    """Accumulate ``value`` onto the counter keyed by name + attrs."""
    rec = _RECORDER
    if rec is not None:
        rec.add_counter(name, value, attrs or None)


def gauge(name: str, value: float, **attrs) -> None:
    """Set the last-value gauge keyed by name + attrs."""
    rec = _RECORDER
    if rec is not None:
        rec.add_gauge(name, value, attrs or None)


def summary() -> dict:
    """Summary of the installed recorder (``{}`` when disabled)."""
    rec = _RECORDER
    return {} if rec is None else rec.summary()
