"""Event core: spans, counters, gauges, the process-global Recorder and
per-thread recorders.

A standard-library copy of the part of :mod:`mpit_tpu.obs.core` the
serving scheduler, the compat simulator and the fleet use. Every
primitive is two module-global reads when no recorder is installed:
:func:`span` then returns a shared no-op context manager, so
instrumentation costs nothing until :func:`enable` or
:func:`local_recorder`.

- a *span* is ``("X", name, t0, dur, tid, attrs)``, a named wall-clock
  interval on a thread (``t0`` in seconds since the recorder's epoch);
  an *instant* is ``("i", name, t, 0.0, tid, attrs)``, a marker;
- *counters* accumulate floats keyed by ``(name, attrs)``; *gauges*
  keep the last value;
- a *thread-local* recorder (:func:`local_recorder`) takes the place of
  the global one on its thread: each rank thread of a compat job keeps
  its own event stream, which :mod:`mpit_tpu_torch.obs.aggregate`
  drains and merges.
"""

from __future__ import annotations

import contextlib
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
    "get_global_recorder",
    "get_recorder",
    "instant",
    "local_recorder",
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
        self._thread_names: dict[int, str] = {}

    def _add_event(self, event: tuple) -> None:
        th = threading.current_thread()
        with self._lock:
            if len(self.events) >= self._max_events:
                self.dropped += 1
                return
            self._thread_names.setdefault(th.ident, th.name)
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
                "thread_names": dict(self._thread_names),
                "dropped": self.dropped,
            }

    def drain(self) -> dict:
        """Snapshot AND clear: a flight-recorder gather ships each
        interval's events once."""
        with self._lock:
            out = {
                "events": self.events,
                "counters": self.counters,
                "gauges": self.gauges,
                "thread_names": dict(self._thread_names),
                "dropped": self.dropped,
            }
            self.events = []
            self.counters = {}
            self.gauges = {}
            self.dropped = 0
        return out

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
# Thread-local overrides (local_recorder); _TLS_ACTIVE counts the
# installed ones, so the disabled fast path stays two global reads.
_TLS = threading.local()
_TLS_ACTIVE = 0


def _current() -> Recorder | None:
    """The recorder the calling thread records into: its thread-local
    override when one is installed, else the global one."""
    if _TLS_ACTIVE:
        rec = getattr(_TLS, "recorder", None)
        if rec is not None:
            return rec
    return _RECORDER


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
        rec = _current()
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
    return _current() is not None


def get_recorder() -> Recorder | None:
    """The calling thread's recorder (its thread-local override first)."""
    return _current()


def get_global_recorder() -> Recorder | None:
    """The process-global recorder only, whatever the calling thread's
    override: for code that records on behalf of another thread (the
    compat simulator delivers a receive on the sender's thread)."""
    return _RECORDER


@contextlib.contextmanager
def local_recorder(recorder: Recorder | None = None):
    """Install a thread-local recorder for the enclosed block: every
    primitive called on this thread records into it instead of the
    global recorder; other threads are untouched. Nests (the previous
    override is restored on exit) and yields the recorder."""
    global _TLS_ACTIVE
    rec = recorder if recorder is not None else Recorder()
    prev = getattr(_TLS, "recorder", None)
    with _LOCK:
        _TLS_ACTIVE += 1
    _TLS.recorder = rec
    try:
        yield rec
    finally:
        _TLS.recorder = prev
        with _LOCK:
            _TLS_ACTIVE -= 1


def span(name: str, **attrs):
    """Context manager timing a named phase."""
    if _current() is None:
        return _NOOP
    return _Span(name, attrs or None)


def span_at(name: str, t0: float, t1: float, **attrs) -> None:
    """Record a completed span from explicit ``time.perf_counter``
    timestamps: the per-request ``queue_wait`` / ``request_ttft`` /
    ``request_latency`` intervals span many loop ticks."""
    rec = _current()
    if rec is not None:
        rec.add_span(name, t0, t1, attrs or None)


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event."""
    rec = _current()
    if rec is not None:
        rec.add_instant(name, attrs or None)


def counter(name: str, value: float = 1.0, **attrs) -> None:
    """Accumulate ``value`` onto the counter keyed by name + attrs."""
    rec = _current()
    if rec is not None:
        rec.add_counter(name, value, attrs or None)


def gauge(name: str, value: float, **attrs) -> None:
    """Set the last-value gauge keyed by name + attrs."""
    rec = _current()
    if rec is not None:
        rec.add_gauge(name, value, attrs or None)


def summary() -> dict:
    """Summary of the calling thread's recorder (``{}`` when disabled)."""
    rec = _current()
    return {} if rec is None else rec.summary()
