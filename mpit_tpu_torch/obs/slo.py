"""Declarative SLOs evaluated over rolling windows: the port of
:mod:`mpit_tpu.obs.slo`.

A service promise ("p95 TTFT ≤ X under production traffic") becomes a
measured signal: an :class:`SLO`
declares the target, an :class:`SLOMonitor` evaluates every declared
target against a :class:`~mpit_tpu_torch.obs.stream.StreamRegistry`'s rolling
windows each time the serve loop asks, and breach state transitions are

- emitted as structured ``slo_breach`` / ``slo_recovered`` instants
  through the installed Recorder (they land in the Chrome trace next to
  the guilty decode/prefill spans),
- fed to an optional :class:`~mpit_tpu_torch.obs.sentinel.Sentinel` via
  :meth:`Sentinel.note`, so ``Sentinel.report()`` — the run's one
  anomaly verdict — carries SLO breaches alongside spike/degradation
  findings,
- accumulated into :meth:`SLOMonitor.report`: per-target breach count,
  **time in breach** (seconds the target was continuously violated) and
  **time to detect** (the gap between the last compliant evaluation and
  the evaluation that flagged the breach — the monitor's detection
  granularity, bounded by how often the loop evaluates).

Three target kinds cover the serving SLOs:

- ``quantile``: windowed ``registry.quantile(metric, q) <= max_value``
  (p95 TTFT, p95 latency);
- ``rate``: windowed ``registry.rate(metric) <= max_value`` (e.g.
  errors/s);
- ``ratio``: windowed event-count ratio ``window_total(metric) /
  window_total(denom_metric) <= max_value`` (shed-rate ≤ Z as
  shed/arrivals — counts over the SAME window, so two series that
  started at different times can't skew the ratio the way two
  independently span-clamped rates would).

A quantile target with fewer than ``min_count`` windowed observations
abstains (no breach, no recovery): two requests must not declare an
SLO breach, nor may an empty window declare recovery mid-incident.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from mpit_tpu_torch.obs import core as _obs
from mpit_tpu_torch.obs.stream import StreamRegistry

__all__ = ["SLO", "SLOMonitor"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative target: ``<derived value> <= max_value``.

    ``name`` labels the emitted events and the report entry; ``metric``
    names the registry series. ``kind`` is ``"quantile"`` (default,
    with ``q``), ``"rate"``, or ``"ratio"`` (with ``denom_metric``).
    """

    name: str
    metric: str
    max_value: float
    kind: str = "quantile"
    q: float = 0.95
    denom_metric: str = ""

    def __post_init__(self):
        if self.kind not in ("quantile", "rate", "ratio"):
            raise ValueError(
                f"SLO {self.name!r}: kind must be quantile|rate|ratio, "
                f"got {self.kind!r}"
            )
        if self.kind == "ratio" and not self.denom_metric:
            raise ValueError(
                f"SLO {self.name!r}: ratio targets need denom_metric"
            )

    @classmethod
    def ttft_p95(cls, max_s: float) -> "SLO":
        return cls(name="ttft_p95", metric="request_ttft", max_value=max_s)

    @classmethod
    def latency_p95(cls, max_s: float) -> "SLO":
        return cls(
            name="latency_p95", metric="request_latency", max_value=max_s
        )

    @classmethod
    def shed_rate(cls, max_fraction: float) -> "SLO":
        return cls(
            name="shed_rate", metric="serve_shed", kind="ratio",
            denom_metric="serve_arrivals", max_value=max_fraction,
        )


class _TargetState:
    __slots__ = ("in_breach", "breaches", "breach_started", "time_in_breach",
                 "last_ok_t", "last_eval_t", "detect_lags", "last_value",
                 "worst_value")

    def __init__(self):
        self.in_breach = False
        self.breaches = 0
        self.breach_started: float | None = None
        self.time_in_breach = 0.0
        self.last_ok_t: float | None = None
        self.last_eval_t: float | None = None
        self.detect_lags: list[float] = []
        self.last_value: float | None = None
        self.worst_value: float | None = None


class SLOMonitor:
    """Evaluates declared SLOs against a registry's rolling windows.

    The serve loop calls :meth:`evaluate` once per tick (it is
    O(targets × buckets)); transitions emit instants / sentinel notes,
    steady state only accumulates time-in-breach. ``min_count`` guards
    quantile targets against verdicts on near-empty windows.
    """

    def __init__(
        self,
        targets,
        registry: StreamRegistry,
        *,
        min_count: int = 8,
        sentinel=None,
    ):
        self.targets = tuple(targets)
        names = [t.name for t in self.targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.registry = registry
        self.min_count = min_count
        self.sentinel = sentinel
        self._state = {t.name: _TargetState() for t in self.targets}

    # -- evaluation ---------------------------------------------------------
    def _value(self, slo: SLO, now: float) -> float | None:
        if slo.kind == "quantile":
            if self.registry.window_count(slo.metric, now) < self.min_count:
                return None
            return self.registry.quantile(slo.metric, slo.q, now)
        if slo.kind == "rate":
            return self.registry.rate(slo.metric, now)
        # Ratio = windowed COUNTS, not a ratio of rates: rate() clamps
        # its span to each series' own first event, so a young numerator
        # series (first shed seconds ago) over an old denominator would
        # overstate the ratio by window_s/age and fire spurious
        # breaches. Counts share one window edge by construction.
        denom = self.registry.window_total(slo.denom_metric, now)
        if denom <= 0.0:
            return None  # no traffic: a shed ratio is undefined, not 0
        return self.registry.window_total(slo.metric, now) / denom

    def evaluate(self, now: float | None = None, tick: int = 0) -> list[dict]:
        """One evaluation pass; returns the TRANSITIONS it produced
        (``[{event: "slo_breach"|"slo_recovered", slo, value, ...}]``,
        usually empty)."""
        now = self.registry.clock() if now is None else now
        out: list[dict] = []
        for slo in self.targets:
            st = self._state[slo.name]
            value = self._value(slo, now)
            if value is None:
                # Abstain: too little data for a verdict. An open
                # incident stays open (no recovery on silence) AND its
                # clock keeps running — a bursty run that breaches in
                # every on-phase must not have its off-phases excluded
                # from time-in-breach.
                if st.in_breach:
                    st.time_in_breach += now - (st.last_eval_t or now)
                st.last_eval_t = now
                continue
            st.last_value = value
            breach = value > slo.max_value
            if breach:
                st.worst_value = (
                    value if st.worst_value is None
                    else max(st.worst_value, value)
                )
                if st.in_breach:
                    st.time_in_breach += now - (st.last_eval_t or now)
                else:
                    st.in_breach = True
                    st.breaches += 1
                    st.breach_started = now
                    # Detection lag: how long after the last compliant
                    # evaluation the monitor NOTICED — the evaluation
                    # cadence is the floor on detection, and the
                    # roll-up shows whether the loop evaluates often
                    # enough for the SLO it claims to watch.
                    lag = now - (
                        st.last_ok_t if st.last_ok_t is not None else now
                    )
                    st.detect_lags.append(lag)
                    record = {
                        "event": "slo_breach", "slo": slo.name,
                        "metric": slo.metric, "value": round(value, 6),
                        "max_value": slo.max_value, "tick": tick,
                        "detect_lag_s": round(lag, 6),
                    }
                    out.append(record)
                    _obs.instant("slo_breach", **record)
                    if self.sentinel is not None:
                        self.sentinel.note(
                            "slo_breach", slo.name, tick,
                            value=value, max_value=slo.max_value,
                        )
            else:
                if st.in_breach:
                    st.in_breach = False
                    st.time_in_breach += now - (st.last_eval_t or now)
                    dur = now - (st.breach_started or now)
                    record = {
                        "event": "slo_recovered", "slo": slo.name,
                        "metric": slo.metric, "value": round(value, 6),
                        "max_value": slo.max_value, "tick": tick,
                        "breach_duration_s": round(dur, 6),
                    }
                    out.append(record)
                    _obs.instant("slo_recovered", **record)
                st.last_ok_t = now
            st.last_eval_t = now
        return out

    def finish(self, now: float | None = None) -> None:
        """Close out open breaches' time-in-breach at end of run (no
        recovery event is emitted — the run ended in breach, and the
        report says so via ``in_breach``)."""
        now = self.registry.clock() if now is None else now
        for st in self._state.values():
            if st.in_breach:
                st.time_in_breach += now - (st.last_eval_t or now)
                st.last_eval_t = now

    # -- reading ------------------------------------------------------------
    @property
    def breached(self) -> bool:
        return any(st.breaches for st in self._state.values())

    def report(self) -> dict:
        """Per-target roll-up + the headline ``ok`` boolean. Rounded,
        JSON-ready — lands in the serving CLI's output."""
        targets: dict[str, Any] = {}
        for slo in self.targets:
            st = self._state[slo.name]
            entry: dict[str, Any] = {
                "kind": slo.kind,
                "metric": slo.metric,
                "max_value": slo.max_value,
                "breaches": st.breaches,
                "in_breach": st.in_breach,
                "time_in_breach_s": round(st.time_in_breach, 6),
            }
            if slo.kind == "quantile":
                entry["q"] = slo.q
            if st.last_value is not None:
                entry["last_value"] = round(st.last_value, 6)
            if st.worst_value is not None:
                entry["worst_value"] = round(st.worst_value, 6)
            if st.detect_lags:
                entry["time_to_detect_s"] = round(
                    sum(st.detect_lags) / len(st.detect_lags), 6
                )
            targets[slo.name] = entry
        return {"ok": not self.breached, "targets": targets}
