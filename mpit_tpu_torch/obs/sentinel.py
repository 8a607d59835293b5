"""Step-time anomaly sentinel: the port of :mod:`mpit_tpu.obs.sentinel`,
``DivergenceGuard`` for throughput.

The divergence guard watches the loss; this module watches time (the
offline half is the :mod:`~mpit_tpu_torch.obs.baseline` regression
gate): a rolling median/MAD detector over a loop's phase times — step
time, prefetch wait, host fence, a serving tick — that flags

- ``spike``: one observation far above the rolling median (a stall,
  a preemption hiccup, a contended tunnel);
- ``sustained_degradation``: several consecutive observations above a
  lower threshold (the run got durably slower — a thermal throttle, a
  neighbor, a regression that warmup hid);
- ``prefetch_starvation``: prefetch wait dominating step wall for
  several consecutive steps (input pipeline can't keep up).

Detection is robust (median/MAD, not mean/std — one spike must not
inflate its own baseline) with a relative floor on the MAD so
near-constant synthetic workloads don't flag their own noise.

Anomalies are emitted as structured ``obs.instant("anomaly", ...)``
events (they land in the trace, next to the span that caused them) and
accumulated for :meth:`Sentinel.report`, which ``hardened_loop`` and
the serving CLI attach to their results when a sentinel is wired in
(``sentinel=`` / ``--sentinel true``). The port's training loop feeds
it the device's step times (:func:`mpit_tpu_torch.train.hardened_loop`),
not the host's dispatch wall.

Pure stdlib + the obs core: usable standalone on any stream of
durations, not just the training loop.
"""

from __future__ import annotations

import statistics
from collections import deque
from typing import Any

from mpit_tpu_torch.obs import core as _obs

__all__ = ["Sentinel"]


class _Detector:
    """Rolling median/MAD detector for one metric."""

    __slots__ = ("window", "count", "total", "above_streak", "in_excursion")

    def __init__(self, window: int):
        self.window = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.above_streak = 0
        # Are we INSIDE an above-baseline excursion? A spike alert fires
        # only on the transition below→above, so a durable slowdown is
        # one spike + sustained-degradation alerts, never a spike storm.
        self.in_excursion = False

    def baseline(self) -> tuple[float, float]:
        med = statistics.median(self.window)
        mad = statistics.median(abs(v - med) for v in self.window)
        return med, mad

    def push(self, value: float) -> None:
        self.window.append(value)
        self.count += 1
        self.total += value


class Sentinel:
    """Anomaly detector over the loop's host-side phase times.

    Args:
      window: rolling-window length per metric (median/MAD baseline).
      warmup: observations per metric before any verdicts — the first
        steps carry compile/cache noise the baseline must not flag.
      spike_mads: ``spike`` when value > median + spike_mads·MAD.
      sustained_mads: lower bar for the consecutive-degradation check.
      sustained_n: consecutive above-bar observations that make a
        ``sustained_degradation`` (the streak then resets, so a durably
        slow run re-alerts every ``sustained_n`` observations, not every
        step).
      mad_floor_pct: relative floor on the MAD (as % of the median) so a
        near-constant metric's numeric jitter cannot trip the detector —
        the zero-false-positive guarantee on clean synthetic runs.
      starvation_ratio: ``prefetch_starvation`` when prefetch wait >
        ratio × the loop's iteration wall for ``sustained_n``
        consecutive steps.
      max_anomalies: cap on retained anomaly records (counts keep
        accumulating past it; the overflow is reported).
      phases: the monitored metric names. ``None``
        (default) monitors every metric fed in — the historical
        behavior, and what ``hardened_loop`` relies on. A tuple
        restricts detection to those names: the serve scheduler runs
        the SAME detector on its ``decode``/``prefill`` tick streams
        with ``phases=("decode", "prefill")``, and observations of any
        other metric are dropped — one sentinel instance can be handed
        to several feeders without cross-talk.
    """

    def __init__(
        self,
        *,
        window: int = 64,
        warmup: int = 8,
        spike_mads: float = 8.0,
        sustained_mads: float = 4.0,
        sustained_n: int = 5,
        mad_floor_pct: float = 5.0,
        starvation_ratio: float = 0.5,
        max_anomalies: int = 64,
        phases: tuple[str, ...] | None = None,
        on_note: "callable | None" = None,
    ):
        self.window = window
        self.warmup = max(2, warmup)
        self.spike_mads = spike_mads
        self.sustained_mads = sustained_mads
        self.sustained_n = max(1, sustained_n)
        self.mad_floor_pct = mad_floor_pct
        self.starvation_ratio = starvation_ratio
        self.max_anomalies = max_anomalies
        self.phases = tuple(phases) if phases is not None else None
        # Detection-time fan-out: called with every
        # emitted record — built-in detections AND external note()s —
        # so a request-lifecycle ledger can pin the in-flight set the
        # moment a breach/anomaly fires (the instant and the requests
        # that caused it are otherwise unjoinable). The serve scheduler
        # chains onto this; it is a public, reassignable attribute.
        self.on_note = on_note
        self._detectors: dict[str, _Detector] = {}
        self._anomalies: list[dict] = []
        self._counts: dict[str, int] = {}
        self._starve_streak = 0

    # -- recording ----------------------------------------------------------
    def _emit(self, kind: str, metric: str, step: int, **extra) -> None:
        self._counts[kind] = self._counts.get(kind, 0) + 1
        record = {"kind": kind, "metric": metric, "step": int(step)}
        record.update({k: round(v, 6) if isinstance(v, float) else v
                       for k, v in extra.items()})
        if len(self._anomalies) < self.max_anomalies:
            self._anomalies.append(record)
        # Structured instant: lands in the trace next to the guilty span.
        _obs.instant("anomaly", **record)
        if self.on_note is not None:
            self.on_note(record)

    def note(self, kind: str, metric: str, step: int, **extra) -> None:
        """Record an EXTERNALLY detected anomaly into this sentinel's
        report (counted, capped, and emitted as an ``anomaly`` instant
        like the built-in detections). The SLO monitor (``obs.slo``)
        feeds breaches through here so ``Sentinel.report()`` — the
        run's one anomaly verdict — carries them next to spike /
        sustained-degradation findings; ``clean`` goes false."""
        self._emit(kind, metric, step, **extra)

    def observe(self, metric: str, step: int, value: float) -> None:
        """Feed one observation of ``metric`` (seconds) at ``step``.
        Ignored when a ``phases`` tuple is configured and doesn't name
        ``metric``."""
        if self.phases is not None and metric not in self.phases:
            return
        det = self._detectors.get(metric)
        if det is None:
            det = self._detectors[metric] = _Detector(self.window)
        if det.count < self.warmup:
            # Warmup: build the baseline, no verdicts.
            det.push(value)
            return
        med, mad = det.baseline()
        mad = max(mad, self.mad_floor_pct / 100.0 * med, 1e-12)
        if value > med + self.spike_mads * mad:
            det.count += 1
            det.total += value
            det.above_streak += 1
            if not det.in_excursion:
                # Transition below→above: a spike. Excluded from the
                # rolling window — a ONE-OFF must not raise the
                # baseline and mask a second, smaller anomaly.
                det.in_excursion = True
                self._emit(
                    "spike", metric, step,
                    value_s=value, median_s=med, mad_s=mad,
                )
            else:
                # A CONTINUING excursion is not more spikes — it is the
                # run durably slowing down: feed the window so the
                # baseline adapts to the new normal (alerts stop once
                # the median catches up), and name it as sustained
                # degradation every sustained_n steps meanwhile.
                det.window.append(value)
                if det.above_streak >= self.sustained_n:
                    self._emit(
                        "sustained_degradation", metric, step,
                        value_s=value, median_s=med,
                        consecutive=det.above_streak,
                    )
                    det.above_streak = 0
            return
        if value > med + self.sustained_mads * mad:
            # Above the lower bar: part of an excursion (a later
            # spike-bar value is its continuation, not a fresh spike).
            det.in_excursion = True
            det.above_streak += 1
            if det.above_streak >= self.sustained_n:
                self._emit(
                    "sustained_degradation", metric, step,
                    value_s=value, median_s=med,
                    consecutive=det.above_streak,
                )
                det.above_streak = 0
        else:
            det.in_excursion = False
            det.above_streak = 0
        det.push(value)

    def observe_phases(self, tick: int, **values: float) -> None:
        """Feed several named phase durations for one tick — the
        metric-agnostic counterpart of :meth:`observe_step` (the serve
        scheduler calls ``observe_phases(tick, decode=..., prefill=...)``
        per loop iteration). ``None`` values are skipped; the ``phases``
        filter applies per name. (Positional is named ``tick``, not
        ``step``, so "step" itself stays usable as a phase kwarg.)"""
        for name, value in values.items():
            if value is not None:
                self.observe(name, tick, value)

    def observe_step(
        self,
        step: int,
        *,
        step_s: float,
        prefetch_wait_s: float | None = None,
        iteration_s: float | None = None,
    ) -> None:
        """Per-iteration feed from the loop: step wall (+ prefetch wait).

        Also runs the starvation check — prefetch wait persistently
        dominating the loop's ITERATION wall means the input pipeline,
        not the device, is the binding resource. ``iteration_s`` is the
        full iteration-to-iteration wall (the loop passes it; it covers
        the fence blocking where device time surfaces on the async
        path — judging against ``step_s`` alone would compare prefetch
        wait to the µs-scale dispatch wall and cry starvation on
        healthy device-bound runs). Fallback when absent:
        ``step_s + prefetch_wait_s``.
        """
        self.observe("step", step, step_s)
        if prefetch_wait_s is None:
            return
        self.observe("prefetch_wait", step, prefetch_wait_s)
        if self.phases is not None and "prefetch_wait" not in self.phases:
            return  # starvation is the prefetch_wait metric's verdict
        denom = (
            iteration_s if iteration_s is not None
            else step_s + prefetch_wait_s
        )
        if prefetch_wait_s > self.starvation_ratio * max(denom, 1e-12):
            self._starve_streak += 1
            if self._starve_streak >= self.sustained_n:
                self._emit(
                    "prefetch_starvation", "prefetch_wait", step,
                    prefetch_wait_s=prefetch_wait_s, step_s=step_s,
                    consecutive=self._starve_streak,
                )
                self._starve_streak = 0
        else:
            self._starve_streak = 0

    # -- reading ------------------------------------------------------------
    def report(self) -> dict:
        """End-of-run verdict: anomaly counts + records + per-metric
        baselines. ``clean`` is the headline boolean."""
        metrics: dict[str, Any] = {}
        for name, det in sorted(self._detectors.items()):
            entry = {
                "count": det.count,
                "total_s": round(det.total, 6),
            }
            if len(det.window) >= 2:
                med, mad = det.baseline()
                entry["median_s"] = round(med, 6)
                entry["mad_s"] = round(mad, 6)
            metrics[name] = entry
        out = {
            "clean": not self._counts,
            "anomaly_counts": dict(sorted(self._counts.items())),
            "anomalies": list(self._anomalies),
            "metrics": metrics,
        }
        overflow = sum(self._counts.values()) - len(self._anomalies)
        if overflow > 0:
            out["anomalies_truncated"] = overflow
        return out
