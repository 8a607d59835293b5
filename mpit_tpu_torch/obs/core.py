"""Event core: spans, counters, gauges, the process-global Recorder and
per-thread recorders.

The port of :mod:`mpit_tpu.obs.core` (standard library only; numpy is
imported lazily by the roll-up). Every primitive is two module-global
reads when no recorder is installed: :func:`span` then returns a shared
no-op context manager, so instrumentation costs nothing until
:func:`enable` or :func:`local_recorder`.

- a *span* is ``("X", name, t0, dur, tid, attrs)``, a named wall-clock
  interval on a thread (``t0`` in seconds since the recorder's epoch);
  an *instant* is ``("i", name, t, 0.0, tid, attrs)``, a marker;
- *counters* accumulate floats keyed by ``(name, attrs)``; *gauges*
  keep the last value;
- a *thread-local* recorder (:func:`local_recorder`) takes the place of
  the global one on its thread: each rank thread of a compat job keeps
  its own event stream, which :mod:`mpit_tpu_torch.obs.aggregate`
  drains and merges;
- the *roofline* accounting keeps, per phase, the modeled cost of one
  execution (:meth:`Recorder.add_cost`) and explicitly accumulated
  achieved work (:meth:`Recorder.add_work`); :meth:`Recorder.summary`
  rolls them up through :func:`mpit_tpu_torch.obs.roofline.rollup`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Mapping

__all__ = [
    "Recorder",
    "counter",
    "disable",
    "enable",
    "enabled",
    "gap_attribution",
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
        # Roofline accounting: per phase, one execution's modeled cost
        # (set once, at registration) and the explicit achieved work.
        self.costs: dict[str, dict] = {}
        self.work: dict[str, dict] = {}

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

    def add_cost(self, phase: str, cost: Mapping[str, Any]) -> None:
        """Register a phase's per-execution modeled cost (the last
        registration wins)."""
        with self._lock:
            self.costs[phase] = dict(cost)

    def add_work(
        self,
        phase: str,
        *,
        flops: float | None = None,
        hbm_bytes: float | None = None,
        ici_bytes: float | None = None,
        n: int = 1,
    ) -> None:
        """Accumulate explicit achieved work for a phase; a component
        ever fed here is marked ``explicit``, and the roll-up uses its
        sum instead of executions x the modeled cost."""
        with self._lock:
            w = self.work.setdefault(
                phase,
                {"flops": 0.0, "hbm_bytes": 0.0, "ici_bytes": 0.0, "n": 0,
                 "explicit": set()},
            )
            w["n"] += n
            for key, value in (("flops", flops), ("hbm_bytes", hbm_bytes),
                               ("ici_bytes", ici_bytes)):
                if value is not None:
                    w[key] += float(value)
                    w["explicit"].add(key)

    def snapshot(self) -> dict:
        """Consistent copy of all buffers."""
        with self._lock:
            return {
                "events": list(self.events),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "thread_names": dict(self._thread_names),
                "dropped": self.dropped,
                "costs": {k: dict(v) for k, v in self.costs.items()},
                "work": {k: {**v, "explicit": set(v["explicit"])}
                         for k, v in self.work.items()},
            }

    def counter_items(self, name: str) -> Iterator[tuple[dict, float]]:
        """``(attrs, value)`` for every counter series named ``name``."""
        with self._lock:
            items = [(dict(k[1]), v) for k, v in self.counters.items() if k[0] == name]
        return iter(items)

    def counter_total(self, name: str) -> float:
        """A counter's sum over all its attribute sets."""
        with self._lock:
            return sum(v for k, v in self.counters.items() if k[0] == name)

    def event_count(self) -> int:
        """The event buffer's length: a cursor for ``summary(since=)``."""
        with self._lock:
            return len(self.events)

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
                "costs": self.costs,
                "work": self.work,
            }
            self.events = []
            self.counters = {}
            self.gauges = {}
            self.dropped = 0
            self.costs = {}
            self.work = {}
        return out

    def summary(self, *, top_collectives: int = 5, since: int = 0) -> dict:
        """``{"phases": {name: {count, total_s, p50_s, p95_s[, labels]}},
        "collectives": [...], "counters": {name: total}[, "roofline"]
        [, "instants": {name: count}], "dropped_events": n}``.

        String span attributes are mode labels (e.g.
        ``attention="kernel"``): their distinct values roll up under the
        phase's ``labels``. ``collectives`` lists the top ops by the
        ``collective_bytes`` counter (modeled wire bytes). ``since``
        restricts the phase roll-up to events from that buffer index on
        (:meth:`event_count`); counters are cumulative either way, and the
        ``roofline`` section (registered costs against span seconds,
        ``compile`` overlay seconds excluded) appears only unscoped:
        achieved work is not indexed by event."""
        snap = self.snapshot()
        by_name: dict[str, list[float]] = {}
        labels: dict[str, dict[str, set]] = {}
        instants: dict[str, int] = {}
        compile_s: dict[str, float] = {}
        for kind, name, _t0, dur, _tid, attrs in snap["events"][since:]:
            if kind == "i":
                instants[name] = instants.get(name, 0) + 1
                continue
            by_name.setdefault(name, []).append(dur)
            if name == "compile" and attrs and "phase" in attrs:
                compile_s[attrs["phase"]] = compile_s.get(attrs["phase"], 0.0) + dur
            for k, v in (attrs or {}).items():
                if isinstance(v, str):
                    labels.setdefault(name, {}).setdefault(k, set()).add(v)
        phases = phase_stats(by_name)
        for name, lab in labels.items():
            phases[name]["labels"] = {k: sorted(vs) for k, vs in lab.items()}
        colls = [(dict(k[1]), v) for k, v in snap["counters"].items()
                 if k[0] == "collective_bytes"]
        colls.sort(key=lambda kv: kv[1], reverse=True)
        collectives = [{**attrs, "wire_bytes": v} for attrs, v in colls[:top_collectives]]
        counters: dict[str, float] = {}
        for (name, _akey), v in snap["counters"].items():
            counters[name] = counters.get(name, 0.0) + v
        out = {"phases": phases, "collectives": collectives, "counters": counters}
        if snap["costs"] and since == 0:
            from mpit_tpu_torch.obs import roofline as _roofline

            out["roofline"] = _roofline.rollup(
                snap["costs"], snap["work"], phases, overlay_seconds=compile_s
            )
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


def summary(*, top_collectives: int = 5, since: int = 0) -> dict:
    """Summary of the calling thread's recorder (``{}`` when disabled)."""
    rec = _current()
    if rec is None:
        return {}
    return rec.summary(top_collectives=top_collectives, since=since)


# The training loop's host phases around the step (``hardened_loop``'s
# spans); the prefetch thread's own stages overlap the loop and are
# reported apart. Overlay phases nest inside another phase's span (a
# ``compile`` span covers the call that built a kernel library) and are
# never summed into the loop's wall.
_HOST_PHASES = ("prefetch_wait", "host_fence", "checkpoint_save", "eval",
                "divergence_restore")
_OVERLAPPED_PHASES = ("prefetch_host", "prefetch_device_put")
_OVERLAY_PHASES = ("compile",)


def gap_attribution(summ: Mapping | None = None) -> dict:
    """Attribute a training run's loop wall across its phases: ``step``
    against each host phase, with the host share of the loop total
    (``summ``: a :func:`summary`-shaped dict, default the installed
    recorder's). A large ``host_fence`` share is the host waiting for the
    device; a large ``prefetch_wait`` share is input starvation."""
    if summ is None:
        summ = summary()
    phases = summ.get("phases", {}) if summ else {}
    step_s = phases.get("step", {}).get("total_s", 0.0)
    host = {n: phases[n]["total_s"] for n in _HOST_PHASES if n in phases}
    overlap = {n: round(phases[n]["total_s"], 4) for n in _OVERLAPPED_PHASES if n in phases}
    host_s = sum(host.values())
    loop_s = step_s + host_s
    out = {
        "loop_s": round(loop_s, 4),
        "step_s": round(step_s, 4),
        "host_s": round(host_s, 4),
        "host_phases_s": {n: round(v, 4) for n, v in sorted(host.items())},
        "host_share_pct": round(100.0 * host_s / loop_s, 2) if loop_s else 0.0,
    }
    if overlap:
        out["overlapped_s"] = overlap
    return out
