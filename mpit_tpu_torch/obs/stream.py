"""Bounded-memory streaming metrics: quantile sketch + rolling windows,
a standard-library copy of :mod:`mpit_tpu.obs.stream`.

The Recorder (``obs.core``) retains every span and rolls percentiles up
once, at end of run — exactly right for a bench window, exactly wrong
for a sustained serving run: a multi-minute load test exhausts
``max_events`` and the "percentiles" silently describe a truncated
prefix. This module is the streaming counterpart the serving fleet's
router feeds per tick report:

- :class:`HistogramSketch` — a log-bucketed quantile sketch in the
  DDSketch family (arXiv 1908.10693): geometric buckets with ratio
  ``gamma = (1+a)/(1-a)`` hold counts, so any quantile is answered with
  relative error ≤ ``a`` (default 1%) from O(buckets) memory, values
  never retained. Sketches over the same ``rel_err`` MERGE by adding
  bucket counts — the property the rolling window and any future
  cross-rank aggregation are built on.
- :class:`WindowedHistogram` — a ring of per-interval sub-sketches;
  ``quantile()`` merges the live intervals, so "p95 TTFT over the last
  10 s" costs O(buckets) and old traffic ages out by bucket, not by
  event.
- :class:`StreamRegistry` — the named-metric surface: windowed
  histograms (``observe``), windowed rates (``inc``), last-value gauges
  (``set_gauge``), one ``window_stats()`` roll-up.

Everything is host-side pure Python + math — one ``observe`` is a log,
a dict increment, and a ring-slot check.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, Mapping

__all__ = ["HistogramSketch", "StreamRegistry", "WindowedHistogram"]


class HistogramSketch:
    """Mergeable log-bucketed quantile sketch for non-negative values.

    Bucket ``i`` covers ``(gamma**(i-1), gamma**i]`` with
    ``gamma = (1 + rel_err) / (1 - rel_err)``; the representative value
    ``2 * gamma**i / (gamma + 1)`` (the geometric midpoint) is within
    ``rel_err`` of every value in the bucket — the quantile-error
    guarantee. Values ``<= min_value`` land in a dedicated zero bucket
    (durations of 0.0 are legal and must not take a log).

    Memory is O(distinct buckets): a span of values covering 1 µs..100 s
    at 1% relative error is ~900 buckets, independent of how many
    billions of observations land in them.
    """

    __slots__ = ("rel_err", "min_value", "_gamma", "_log_gamma", "buckets",
                 "zero_count", "count", "sum", "min", "max")

    def __init__(self, *, rel_err: float = 0.01, min_value: float = 1e-9):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self.min_value = min_value
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ----------------------------------------------------------
    def add(self, value: float, n: int = 1) -> None:
        if value < 0.0:
            raise ValueError(
                f"HistogramSketch holds non-negative values (durations, "
                f"rates); got {value}"
            )
        self.count += n
        self.sum += value * n
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value <= self.min_value:
            self.zero_count += n
            return
        idx = math.ceil(math.log(value) / self._log_gamma)
        self.buckets[idx] = self.buckets.get(idx, 0) + n

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        """Fold ``other`` into ``self`` (returns self). Requires equal
        ``rel_err`` — bucket indices are only meaningful per gamma."""
        if other.rel_err != self.rel_err:
            raise ValueError(
                f"cannot merge sketches with different rel_err "
                f"({self.rel_err} vs {other.rel_err})"
            )
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "HistogramSketch":
        out = HistogramSketch(rel_err=self.rel_err, min_value=self.min_value)
        out.buckets = dict(self.buckets)
        out.zero_count = self.zero_count
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    # -- reading ------------------------------------------------------------
    def quantile(self, q: float) -> float | None:
        """The value at quantile ``q`` (0..1), within ``rel_err``
        relative error of the true order statistic; ``None`` when
        empty. The returned value is clamped to the observed
        ``[min, max]`` so bucket-midpoint rounding can never report a
        value outside the data."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return min(max(0.0, self.min), self.max)
        seen = self.zero_count
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen > rank:
                mid = 2.0 * self._gamma ** idx / (self._gamma + 1.0)
                return min(max(mid, self.min), self.max)
        return self.max  # float accumulation fell one short: top bucket

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def summary(self, quantiles: Iterable[float] = (0.5, 0.95)) -> dict:
        """``{count, mean, min, max, p50, p95, ...}`` (empty: count 0)."""
        if self.count == 0:
            return {"count": 0}
        out = {
            "count": self.count,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
        }
        for q in quantiles:
            out[f"p{round(q * 100):d}"] = self.quantile(q)
        return out


class WindowedHistogram:
    """A rolling time window over a :class:`HistogramSketch`.

    The window is ``intervals`` sub-sketches of ``interval_s`` seconds
    each (total span ``intervals * interval_s``); an observation lands
    in the sub-sketch of its interval, and a query merges the sub-
    sketches still inside the window — old traffic expires a whole
    interval at a time, which is the usual sliding-window-counter
    trade: the window edge is quantized to ``interval_s``, memory is
    bounded at ``intervals`` sketches regardless of run length.

    Timestamps are caller-supplied seconds (any monotonic epoch;
    ``time.perf_counter()`` in production, hand-rolled in tests).
    """

    __slots__ = ("interval_s", "intervals", "rel_err", "_ring", "_total")

    def __init__(
        self,
        *,
        window_s: float = 10.0,
        intervals: int = 10,
        rel_err: float = 0.01,
    ):
        if window_s <= 0 or intervals < 1:
            raise ValueError(
                f"need window_s > 0 and intervals >= 1, got "
                f"{window_s}/{intervals}"
            )
        self.interval_s = window_s / intervals
        self.intervals = intervals
        self.rel_err = rel_err
        # ring: slot -> (interval_index, sketch); lazily (re)filled.
        self._ring: dict[int, tuple[int, HistogramSketch]] = {}
        # All-time sketch: the closed-loop/end-of-run view, and the
        # "windowed vs exact" acceptance comparison's subject.
        self._total = HistogramSketch(rel_err=rel_err)

    def _slot(self, t: float) -> tuple[int, HistogramSketch]:
        idx = int(t // self.interval_s)
        slot = idx % self.intervals
        cur = self._ring.get(slot)
        if cur is None or cur[0] != idx:
            cur = (idx, HistogramSketch(rel_err=self.rel_err))
            self._ring[slot] = cur
        return cur

    def observe(self, value: float, t: float) -> None:
        self._slot(t)[1].add(value)
        self._total.add(value)

    def _live(self, now: float) -> Iterable[HistogramSketch]:
        lo = int(now // self.interval_s) - self.intervals + 1
        for idx, sk in self._ring.values():
            if idx >= lo:
                yield sk

    def window_sketch(self, now: float) -> HistogramSketch:
        """Merged sketch of the observations inside the window at
        ``now`` (O(intervals · buckets))."""
        out = HistogramSketch(rel_err=self.rel_err)
        for sk in self._live(now):
            out.merge(sk)
        return out

    def quantile(self, q: float, now: float) -> float | None:
        return self.window_sketch(now).quantile(q)

    def count(self, now: float) -> int:
        return sum(sk.count for sk in self._live(now))

    @property
    def total(self) -> HistogramSketch:
        return self._total


class _WindowedRate:
    """Per-interval event counts; ``rate()`` = window count / window
    span (the span actually covered, so early-run rates aren't diluted
    by not-yet-elapsed window)."""

    __slots__ = ("interval_s", "intervals", "_ring", "_t0", "total")

    def __init__(self, *, window_s: float, intervals: int):
        self.interval_s = window_s / intervals
        self.intervals = intervals
        self._ring: dict[int, tuple[int, float]] = {}
        self._t0: float | None = None
        self.total = 0.0

    def inc(self, value: float, t: float) -> None:
        if self._t0 is None:
            self._t0 = t
        self.total += value
        idx = int(t // self.interval_s)
        slot = idx % self.intervals
        cur = self._ring.get(slot)
        if cur is None or cur[0] != idx:
            cur = (idx, 0.0)
        self._ring[slot] = (idx, cur[1] + value)

    def window_total(self, now: float) -> float:
        lo = int(now // self.interval_s) - self.intervals + 1
        return sum(v for idx, v in self._ring.values() if idx >= lo)

    def rate(self, now: float) -> float:
        span = self.intervals * self.interval_s
        if self._t0 is not None:
            span = min(span, max(now - self._t0, self.interval_s))
        return self.window_total(now) / span


class StreamRegistry:
    """Named windowed metrics — the serve path's live telemetry surface.

    One registry per server run. Three metric kinds:

    - ``observe(name, value)`` — a windowed histogram (latencies,
      queue waits): ``quantile(name, q)`` answers over the rolling
      window, ``.total_sketch(name)`` over the whole run;
    - ``inc(name, value)`` — a windowed rate (requests, tokens, sheds):
      ``rate(name)`` is per-second over the window;
    - ``set_gauge(name, value)`` — last value (queue depth, occupancy).

    ``now``/``t`` default to ``clock()`` (``time.perf_counter``);
    tests pass explicit times for determinism. ``window_stats()`` is
    the one-call roll-up the CLI's live line and the SLO monitor read.
    """

    def __init__(
        self,
        *,
        window_s: float = 10.0,
        intervals: int = 10,
        rel_err: float = 0.01,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.window_s = window_s
        self.intervals = intervals
        self.rel_err = rel_err
        self.clock = clock
        self._hists: dict[str, WindowedHistogram] = {}
        self._rates: dict[str, _WindowedRate] = {}
        self._gauges: dict[str, float] = {}

    # -- feeding ------------------------------------------------------------
    def observe(self, name: str, value: float, t: float | None = None) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = WindowedHistogram(
                window_s=self.window_s, intervals=self.intervals,
                rel_err=self.rel_err,
            )
        h.observe(value, self.clock() if t is None else t)

    def inc(self, name: str, value: float = 1.0, t: float | None = None) -> None:
        r = self._rates.get(name)
        if r is None:
            r = self._rates[name] = _WindowedRate(
                window_s=self.window_s, intervals=self.intervals
            )
        r.inc(value, self.clock() if t is None else t)

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    # -- reading ------------------------------------------------------------
    def quantile(self, name: str, q: float, now: float | None = None):
        h = self._hists.get(name)
        if h is None:
            return None
        return h.quantile(q, self.clock() if now is None else now)

    def window_count(self, name: str, now: float | None = None) -> int:
        h = self._hists.get(name)
        if h is None:
            return 0
        return h.count(self.clock() if now is None else now)

    def rate(self, name: str, now: float | None = None) -> float:
        r = self._rates.get(name)
        if r is None:
            return 0.0
        return r.rate(self.clock() if now is None else now)

    def window_total(self, name: str, now: float | None = None) -> float:
        r = self._rates.get(name)
        if r is None:
            return 0.0
        return r.window_total(self.clock() if now is None else now)

    def counter_total(self, name: str) -> float:
        r = self._rates.get(name)
        return r.total if r is not None else 0.0

    def gauge(self, name: str) -> float | None:
        return self._gauges.get(name)

    def total_sketch(self, name: str) -> HistogramSketch | None:
        h = self._hists.get(name)
        return h.total if h is not None else None

    def window_stats(self, now: float | None = None) -> dict:
        """``{"histograms": {name: {count, p50, p95}}, "rates":
        {name: {rate_per_s, window_total}}, "gauges": {...}}`` over the
        rolling window at ``now`` — the live stats line's payload."""
        now = self.clock() if now is None else now
        hists = {}
        for name, h in sorted(self._hists.items()):
            sk = h.window_sketch(now)
            entry: dict = {"count": sk.count}
            if sk.count:
                entry["p50"] = sk.quantile(0.5)
                entry["p95"] = sk.quantile(0.95)
            hists[name] = entry
        rates = {
            name: {
                "rate_per_s": r.rate(now),
                "window_total": r.window_total(now),
            }
            for name, r in sorted(self._rates.items())
        }
        return {
            "histograms": hists,
            "rates": rates,
            "gauges": dict(sorted(self._gauges.items())),
        }
