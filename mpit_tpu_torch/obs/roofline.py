"""Roofline utilization: measured wall against modeled work (the port of
:mod:`mpit_tpu.obs.roofline`).

- **Cost registration** — a step's per-execution modeled work (FLOPs,
  HBM bytes, and modeled wire bytes where the caller knows them) is
  registered once under the phase name its spans use
  (:func:`register_cost`). The port has no XLA ``cost_analysis`` to
  ask: the serving engine and the training loop register the analytic
  costs of :func:`mpit_tpu_torch.utils.profiling.gpt2_step_cost`
  (``source="analytic"``).
- **Work accumulation** — every span of a registered phase accumulates
  one execution's modeled work; phases whose real work depends on the
  data feed explicit achieved amounts instead (:func:`work`): the
  decode tick feeds HBM bytes from the tiles the length-aware attention
  kernel visits (:func:`decode_step_hbm_bytes`).
- **Roll-up** — ``Recorder.summary()`` divides achieved work by the
  phase's measured span seconds and reports ``mfu_pct`` /
  ``hbm_util_pct`` / ``ici_util_pct`` against the card's peaks, with the
  binding resource (:func:`rollup` / :func:`utilization`).

Honesty rules: modeled costs and achieved-work totals are recorded on
every platform, but percentages are computed only when the recording
platform is ``"cuda"`` and the card's spec is known
(:data:`~mpit_tpu_torch.utils.profiling.KNOWN_CARDS`). A CPU run is
modeled against the H100's peaks (the card the port targets) and
carries the platform label and no percentage; an unknown card carries
its name, no peaks and no percentage. Every figure from a card carries
the card's name and power limit (``nvidia-smi``), read once.

Build observability rides along: :class:`CompileWatch` records the
kernel libraries :mod:`mpit_tpu_torch.ops.build` compiles or loads
inside a watched call (a ``compile`` span overlaying the triggering
phase, a ``compiles`` counter, a ``<scope>_compiles`` gauge); a build
past the pinned expectation (the serving engine pins it after its
warm-up) is an ``unexpected_recompile``. :class:`UtilizationWatch` is
the sustained-collapse rule over a throughput series.

Import-light: torch and ``utils.profiling`` are imported lazily.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import time
from collections import deque
from typing import Any, Mapping

from mpit_tpu_torch.obs import core as _core

__all__ = [
    "CompileWatch",
    "UTIL_KEYS",
    "UtilizationWatch",
    "chip_peaks",
    "decode_step_hbm_bytes",
    "device_card",
    "kv_tile_read_bytes",
    "register_cost",
    "rollup",
    "utilization",
    "work",
]

# Work components a phase can accumulate; the utilization keys computed
# from them on the card, in the same order.
_COMPONENTS = ("flops", "hbm_bytes", "ici_bytes")
UTIL_KEYS = ("mfu_pct", "hbm_util_pct", "ici_util_pct")
_PEAK_BY_COMPONENT = {
    "flops": "peak_flops",
    "hbm_bytes": "peak_hbm",
    "ici_bytes": "peak_ici",
}
_BOUND_BY_COMPONENT = {"flops": "compute", "hbm_bytes": "hbm",
                       "ici_bytes": "ici"}


@functools.cache
def device_card() -> dict:
    """``{"name", "power_limit"}`` of the current CUDA card (``{}``
    without one): the name from ``torch.cuda.get_device_name()``, the
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints it
    (``"unknown"`` when it cannot be read). Read once a process."""
    import torch

    if not torch.cuda.is_available():
        return {}
    name = torch.cuda.get_device_name()
    power = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        )
        idx = torch.cuda.current_device()
        lines = out.stdout.strip().splitlines()
        if idx < len(lines):
            power = lines[idx].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": name, "power_limit": power}


def chip_peaks(chip=None, *, dtype: str = "bf16") -> dict:
    """``{chip, peak_flops, peak_hbm, peak_ici[, peak_dtype, card,
    power_limit]}``. ``chip``: a
    :class:`~mpit_tpu_torch.utils.profiling.ChipSpec`; by default the
    current card's spec (its name and power limit attached), the H100
    SXM's on a host without a card (a modeled figure: no percentage is
    ever computed off the card), and ``None`` peaks on a card without a
    known spec. ``dtype`` picks the arithmetic peak: ``"bf16"`` (tensor
    cores) or ``"f32"``."""
    from mpit_tpu_torch.utils.profiling import H100_SXM, KNOWN_CARDS

    card: dict = {}
    if chip is None:
        card = device_card()
        chip = KNOWN_CARDS.get(card["name"]) if card else H100_SXM
    if chip is None:
        return {"chip": card["name"], "peak_flops": None, "peak_hbm": None,
                "peak_ici": None, "card": card["name"],
                "power_limit": card["power_limit"]}
    out = {
        "chip": chip.name,
        "peak_flops": float(chip.peak_flops_f32 if dtype == "f32" else chip.peak_flops_bf16),
        "peak_hbm": float(chip.hbm_bandwidth),
        "peak_ici": float(chip.ici_bandwidth),
        "peak_dtype": dtype,
    }
    if card:
        out.update(card=card["name"], power_limit=card["power_limit"])
    return out


# ---------------------------------------------------------------------------
# Registration + accumulation (thin wrappers over the Recorder).
# ---------------------------------------------------------------------------


def register_cost(
    phase: str,
    *,
    flops: float = 0.0,
    hbm_bytes: float = 0.0,
    ici_bytes: float = 0.0,
    platform: str,
    chip=None,
    source: str = "analytic",
    dtype: str = "bf16",
) -> None:
    """Register a phase's per-execution modeled work with the calling
    thread's recorder (no-op when obs is disabled). ``platform`` is
    required (``"cuda"`` or ``"cpu"``: the device type the work ran on)
    — it gates the percentages to runs on the card. ``dtype`` picks the
    arithmetic peak (:func:`chip_peaks`)."""
    rec = _core.get_recorder()
    if rec is None:
        return
    rec.add_cost(
        phase,
        {
            "flops": float(flops),
            "hbm_bytes": float(hbm_bytes),
            "ici_bytes": float(ici_bytes),
            "platform": str(platform),
            "source": source,
            **chip_peaks(chip, dtype=dtype),
        },
    )


def work(
    phase: str,
    *,
    flops: float | None = None,
    hbm_bytes: float | None = None,
    ici_bytes: float | None = None,
    n: int = 1,
) -> None:
    """Accumulate EXPLICIT achieved work for a phase. A component fed
    here (even once) switches that component's roll-up from
    ``executions × per-exec modeled`` to the explicit sum — the
    length-aware path for work the padded model over-counts."""
    rec = _core.get_recorder()
    if rec is None:
        return
    rec.add_work(phase, flops=flops, hbm_bytes=hbm_bytes,
                 ici_bytes=ici_bytes, n=n)


# ---------------------------------------------------------------------------
# Roll-up (pure; called by Recorder.summary via lazy import).
# ---------------------------------------------------------------------------


def utilization(
    achieved: Mapping[str, float],
    seconds: float,
    *,
    platform: str,
    peaks: Mapping[str, float],
) -> dict:
    """Achieved rates, and the modeled binding resource and (on a known
    card only) the utilization percentages, for one phase."""
    out: dict[str, Any] = {}
    if seconds > 0:
        out["achieved_gflops_per_s"] = round(
            achieved.get("flops", 0.0) / seconds / 1e9, 3
        )
        out["achieved_hbm_gbps"] = round(
            achieved.get("hbm_bytes", 0.0) / seconds / 1e9, 3
        )
        if achieved.get("ici_bytes"):
            out["achieved_ici_gbps"] = round(
                achieved["ici_bytes"] / seconds / 1e9, 3
            )
    # Binding resource at peak, from the WORK model alone (time-free:
    # t_x = achieved_x / peak_x) — modeled, so honest on any platform.
    known = all(peaks.get(p) for p in _PEAK_BY_COMPONENT.values())
    times = {
        comp: achieved.get(comp, 0.0) / peaks[_PEAK_BY_COMPONENT[comp]]
        for comp in _COMPONENTS
        if known and achieved.get(comp, 0.0) > 0
    }
    if times:
        out["bound_modeled"] = _BOUND_BY_COMPONENT[
            max(times, key=times.get)
        ]
    if platform != "cuda" or not known or seconds <= 0:
        # Seconds measured off the card, or on a card whose peaks are not
        # known: a percentage would be fabricated. The label is the
        # verdict here.
        return out
    out["mfu_pct"] = round(
        100.0 * achieved.get("flops", 0.0) / seconds / peaks["peak_flops"],
        2,
    )
    out["hbm_util_pct"] = round(
        100.0 * achieved.get("hbm_bytes", 0.0) / seconds / peaks["peak_hbm"],
        2,
    )
    if achieved.get("ici_bytes"):
        out["ici_util_pct"] = round(
            100.0 * achieved["ici_bytes"] / seconds / peaks["peak_ici"], 2
        )
    return out


def rollup(
    costs: Mapping[str, Mapping],
    work_acc: Mapping[str, Mapping],
    phases: Mapping[str, Mapping],
    overlay_seconds: Mapping[str, float] | None = None,
) -> dict:
    """The summary's ``roofline`` section: for every registered phase,
    achieved work (explicit where fed, else span count × per-exec
    modeled) against its measured span seconds. Pure function of the
    recorder snapshot, so the offline/baseline paths can reuse it.

    ``overlay_seconds`` maps a phase to time its spans covered that was
    NOT steady-state execution — the ``compile`` overlay spans a
    phase's first call absorbs (the Recorder passes them, keyed by the
    compile span's ``phase`` attr). That time is excluded from the
    utilization denominator: a cold run would otherwise understate
    utilization vs a warm one and make the ``obs diff`` gate trip on
    compile-cache state instead of real regressions (the excluded
    amount is recorded as ``compile_seconds_excluded``)."""
    overlay_seconds = overlay_seconds or {}
    out_phases: dict[str, dict] = {}
    for phase, cost in sorted(costs.items()):
        ph = phases.get(phase, {})
        w = work_acc.get(phase, {})
        explicit = set(w.get("explicit", ()))
        execs = int(ph.get("count", 0)) or int(w.get("n", 0))
        overlay = float(overlay_seconds.get(phase, 0.0))
        seconds = max(float(ph.get("total_s", 0.0)) - overlay, 0.0)
        achieved = {}
        for comp in _COMPONENTS:
            if comp in explicit:
                achieved[comp] = float(w.get(comp, 0.0))
            else:
                achieved[comp] = execs * float(cost.get(comp, 0.0))
        entry: dict[str, Any] = {
            "executions": execs,
            "seconds": round(seconds, 6),
            "platform": cost.get("platform", "unknown"),
            "chip": cost.get("chip"),
            **{k: cost[k] for k in ("card", "power_limit", "source") if k in cost},
            "modeled_flops_per_exec": cost.get("flops", 0.0),
            "modeled_hbm_bytes_per_exec": cost.get("hbm_bytes", 0.0),
        }
        if cost.get("ici_bytes"):
            entry["modeled_ici_bytes_per_exec"] = cost["ici_bytes"]
        for comp in _COMPONENTS:
            if achieved[comp]:
                entry[f"achieved_{comp}"] = achieved[comp]
        if explicit:
            # Which components came from length-aware measurement
            # instead of count × modeled (the honesty label).
            entry["explicit_components"] = sorted(explicit)
        if overlay:
            entry["compile_seconds_excluded"] = round(overlay, 6)
        entry.update(
            utilization(
                achieved, seconds,
                platform=entry["platform"], peaks=cost,
            )
        )
        out_phases[phase] = entry
    return {"phases": out_phases}


# ---------------------------------------------------------------------------
# Decode achieved bytes (the length-aware correction).
# ---------------------------------------------------------------------------


def kv_tile_read_bytes(
    visited_tiles: float, *, block_k: int, kv_row_bytes: float,
    num_layers: int,
) -> float:
    """HBM bytes the flash-decode k-loop reads for ``visited_tiles``
    total visited tiles (summed over slots, ONE layer's tile count —
    every layer visits the same tiles, so the layer factor rides here):
    a K tile and a V tile of ``block_k`` rows each. Tiles the kernel
    skips are never read (``csrc/decode_attention.cu``), which is why
    this — not the padded cache size — is the achieved-bytes figure."""
    return 2.0 * float(visited_tiles) * block_k * kv_row_bytes * num_layers


def decode_step_hbm_bytes(
    visited_tiles: float,
    *,
    block_k: int,
    kv_row_bytes: float,
    num_layers: int,
    param_bytes: float = 0.0,
    appended_rows: int = 0,
) -> float:
    """Modeled HBM traffic of ONE decode tick on the length-aware
    kernel path: every weight read once (T=1 decode re-streams the full
    param tree), the visited K/V tiles, and the K/V rows appended for
    the active slots. Activations/logits are excluded — at T=1 with the
    blocked head they are orders of magnitude below the param read."""
    return (
        float(param_bytes)
        + kv_tile_read_bytes(
            visited_tiles, block_k=block_k, kv_row_bytes=kv_row_bytes,
            num_layers=num_layers,
        )
        + 2.0 * appended_rows * kv_row_bytes * num_layers
    )


# ---------------------------------------------------------------------------
# Build observability.
# ---------------------------------------------------------------------------


class CompileWatch:
    """Records the kernel-library builds and loads of
    :mod:`mpit_tpu_torch.ops.build` that happen inside watched calls,
    and pins a lifetime expectation.

    A watched call during which ``ops.build``'s event count grew paid a
    build (or a first load): a ``compile`` span covering the call is
    recorded (an overlay of the triggering phase's own span), plus a
    ``compiles`` counter and a ``<scope>_compiles`` gauge. Growth past
    ``expected`` (``None``: no expectation yet) emits an
    ``unexpected_recompile`` instant, or a sentinel note when a sentinel
    is attached. The serving engine builds its libraries at
    construction, and ``warm_engine`` pins ``expected`` to the count
    after the warm-up: a build inside the timed window is unexpected.
    """

    def __init__(self, *, expected: int | None = None,
                 scope: str = "engine", sentinel=None):
        self.expected = expected
        self.scope = scope
        self.sentinel = sentinel
        self.compiles = 0
        self.unexpected = 0
        self.events: list[dict] = []

    @staticmethod
    def build_events() -> int:
        from mpit_tpu_torch.ops import build

        return build.event_count()

    def call(self, phase: str, fn, *args, **kwargs):
        """Invoke ``fn(*args, **kwargs)``, recording a compile event if a
        kernel library was built or loaded during the call."""
        before = self.build_events()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.build_events() > before:
            self.on_compile(phase, t0, time.perf_counter())
        return out

    def on_compile(self, phase: str, t0: float, t1: float) -> None:
        self.compiles += 1
        unexpected = (
            self.expected is not None and self.compiles > self.expected
        )
        # The span covers the build and the call's own work (they are
        # one call): the trace reader sees a build-dominated wall.
        _core.span_at(
            "compile", t0, t1, phase=phase, scope=self.scope,
        )
        _core.counter("compiles")
        _core.gauge(f"{self.scope}_compiles", float(self.compiles))
        event = {
            "phase": phase,
            "seconds": round(t1 - t0, 6),
            "count": self.compiles,
            "unexpected": unexpected,
        }
        self.events.append(event)
        if unexpected:
            self.unexpected += 1
            if self.sentinel is not None:
                # note() emits the structured ``anomaly`` instant too.
                self.sentinel.note(
                    "unexpected_recompile", phase, self.compiles,
                    expected=self.expected, scope=self.scope,
                )
            else:
                _core.instant(
                    "unexpected_recompile", phase=phase, scope=self.scope,
                    count=self.compiles, expected=self.expected,
                )


class UtilizationWatch:
    """Sustained utilization collapse: a throughput/utilization series
    (GB/s, MFU %, tokens/s — any higher-is-better rate) dropping below
    ``drop_ratio`` × its rolling median for ``sustained_n`` consecutive
    observations. The duration sentinels can miss this (a tick that
    stays fast while doing half the work looks healthy by wall clock);
    this rule watches the work rate itself. Collapsed values are kept
    OUT of the baseline until an alert fires, then fed in — so a
    permanent step-change alerts a bounded number of times and the
    baseline adapts, mirroring the Sentinel's excursion policy."""

    def __init__(self, *, window: int = 32, warmup: int = 8,
                 drop_ratio: float = 0.5, sustained_n: int = 5,
                 sentinel=None):
        self.window = max(2, window)
        self.warmup = max(2, warmup)
        self.drop_ratio = drop_ratio
        self.sustained_n = max(1, sustained_n)
        self.sentinel = sentinel
        self._windows: dict[str, deque] = {}
        self._streaks: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self.alerts: list[dict] = []

    def observe(self, metric: str, tick: int, value: float) -> None:
        win = self._windows.get(metric)
        if win is None:
            win = self._windows[metric] = deque(maxlen=self.window)
        self._counts[metric] = self._counts.get(metric, 0) + 1
        if self._counts[metric] <= self.warmup:
            win.append(value)
            return
        med = statistics.median(win)
        if med > 0 and value < self.drop_ratio * med:
            streak = self._streaks.get(metric, 0) + 1
            self._streaks[metric] = streak
            if streak >= self.sustained_n:
                self._streaks[metric] = 0
                win.append(value)  # adapt: a durable collapse re-alerts
                # a bounded number of times, then becomes the baseline.
                alert = {
                    "kind": "utilization_collapse",
                    "metric": metric,
                    "tick": int(tick),
                    "value": round(value, 6),
                    "median": round(med, 6),
                    "consecutive": self.sustained_n,
                }
                self.alerts.append(alert)
                if self.sentinel is not None:
                    self.sentinel.note(
                        "utilization_collapse", metric, tick,
                        value=value, median=med,
                    )
                else:
                    _core.instant("anomaly", **alert)
            return
        self._streaks[metric] = 0
        win.append(value)
