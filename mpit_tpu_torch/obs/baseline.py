"""Perf-baseline snapshots and the regression gate behind ``obs diff``
(the port of :mod:`mpit_tpu.obs.baseline`).

A performance claim regresses silently unless something diffs two runs.
This module is the offline half (the runtime half is
:mod:`~mpit_tpu_torch.obs.sentinel`):

- :func:`snapshot` / :func:`save` — a per-phase ``summary()`` snapshot
  (count / total / p50 / p95 per phase, plus counters) in a
  version-tagged JSON shape;
- :func:`load` — reads a baseline file, a raw summary dict, or a
  ``BENCH_DETAIL.json`` (pick the workload with ``workload=``: its
  snapshot under ``obs_baseline``);
- :func:`diff` — the gate: per-phase comparison, regression when the
  current **p50** exceeds baseline by more than ``tolerance_pct``
  (p50 per occurrence, so a run with more steps isn't a "regression";
  ``total_s`` deltas are reported for context, never gated on).

CLI: ``python -m mpit_tpu_torch.obs diff <baseline> <current>
--tolerance-pct N`` exits 0 when clean, 1 on regressions, 2 on unusable
input.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

from mpit_tpu_torch.obs import core

FORMAT = "mpit-obs-baseline-v1"

__all__ = ["FORMAT", "diff", "load", "save", "snapshot"]


def snapshot(
    summary: Mapping[str, Any] | None = None,
    *,
    meta: Mapping | None = None,
    memory: Mapping | None = None,
) -> dict:
    """A baseline snapshot from a ``summary()``-shaped dict (default:
    the calling thread's installed recorder). ``memory=`` attaches the
    memory-ledger gate keys — pass a ``Server.stats()`` ``memory``
    block; only the gateable numerics are kept."""
    if summary is None:
        summary = core.summary()
    if not summary:
        raise RuntimeError(
            "no summary to snapshot — obs is disabled and none was passed"
        )
    out: dict[str, Any] = {
        "format": FORMAT,
        "phases": {
            name: {k: p[k] for k in ("count", "total_s", "p50_s", "p95_s")
                   if k in p}
            for name, p in summary.get("phases", {}).items()
        },
        "counters": dict(summary.get("counters", {})),
    }
    if summary.get("instants"):
        # Zero-duration markers (anomaly / slo_breach / slo_recovered)
        # by count: a load workload's snapshot must record that its SLO
        # tripped, not just its phase times.
        out["instants"] = dict(summary["instants"])
    if summary.get("roofline"):
        # Per-phase utilization: mfu/hbm/ici percentages where
        # the run was on-chip, modeled cost + platform label otherwise —
        # diff() gates on the percentage keys.
        out["roofline"] = {
            "phases": {
                name: dict(entry)
                for name, entry in summary["roofline"]
                .get("phases", {})
                .items()
            }
        }
    if summary.get("dropped_events"):
        # The snapshot's percentiles describe a TRUNCATED buffer — carry
        # the fact so `obs diff` can refuse to gate on it (exit 2).
        out["dropped_events"] = int(summary["dropped_events"])
    if memory:
        # Memory-ledger gate keys: peak held bytes (gated —
        # relative growth beyond tolerance) and the run's minimum KV
        # headroom (reported). Stored only when the source block
        # actually carried ledger numbers, so a pre-ledger snapshot
        # diffs as "no memory section", never as a vacuous pass.
        mem = {
            k: memory[k]
            for k in ("held_peak_bytes", "kv_headroom_min_pct", "platform",
                      "host_held_peak_bytes", "restream_bytes")
            if isinstance(memory.get(k), (int, float, str))
        }
        if isinstance(mem.get("held_peak_bytes"), (int, float)):
            out["memory"] = mem
    if meta:
        out["meta"] = dict(meta)
    return out


def save(
    path: str | Path,
    summary: Mapping[str, Any] | None = None,
    *,
    meta: Mapping | None = None,
    memory: Mapping | None = None,
) -> Path:
    """Write a baseline snapshot JSON (atomic) and return its path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(snapshot(summary, meta=meta, memory=memory), f, indent=1)
    tmp.replace(path)
    return path


def load(path: str | Path, *, workload: str | None = None) -> dict:
    """Load a phase snapshot from any of the shapes the gate accepts.

    - a :func:`save`d baseline file;
    - a raw ``summary()`` dict dumped to JSON (``{"phases": ...}``);
    - a ``BENCH_DETAIL.json`` — pass ``workload=`` to select the entry,
      whose gate-ready snapshot lives under ``obs_baseline``.
    """
    with open(path) as f:
        doc = json.load(f)
    if "workloads" in doc:  # BENCH_DETAIL.json
        if workload is None:
            raise ValueError(
                f"{path} is a BENCH_DETAIL file — pass workload= "
                f"(one of {sorted(doc['workloads'])})"
            )
        entry = doc["workloads"].get(workload)
        if entry is None:
            raise ValueError(
                f"workload {workload!r} not in {sorted(doc['workloads'])}"
            )
        snap = entry.get("obs_baseline")
        if snap is None:
            raise ValueError(
                f"workload {workload!r} carries no obs_baseline snapshot"
            )
        return snap
    if "phases" not in doc:
        raise ValueError(f"{path} holds no phase snapshot")
    return doc


def diff(
    base: Mapping[str, Any],
    cur: Mapping[str, Any],
    *,
    tolerance_pct: float = 10.0,
) -> dict:
    """The regression gate: compare two phase snapshots.

    A phase REGRESSES when its current p50 exceeds the baseline p50 by
    more than ``tolerance_pct``. Improvements and total_s drift are
    reported, not gated. Phases only in one snapshot land in
    ``missing_phases`` / ``new_phases`` — reported here; the CLI treats
    a non-empty ``missing_phases`` as UNUSABLE input (exit 2): a comparison where a baseline phase silently
    disappeared says nothing about the phases that remain.

    Utilization gating: when both snapshots carry a
    ``roofline`` section, a phase whose ``mfu_pct`` / ``hbm_util_pct``
    / ``ici_util_pct`` DROPPED by more than ``tolerance_pct`` (relative)
    is a regression too — time can hold steady while the work done in
    it collapses. Only numeric-on-both-sides keys are compared, so
    platform-labeled off-chip snapshots (which record no percentages)
    never gate vacuously.
    """
    bp = base.get("phases", {})
    cp = cur.get("phases", {})
    phases: dict[str, dict] = {}
    regressions: list[str] = []
    for name in sorted(set(bp) & set(cp)):
        b, c = bp[name], cp[name]
        b50, c50 = float(b.get("p50_s", 0.0)), float(c.get("p50_s", 0.0))
        entry: dict[str, Any] = {
            "base_p50_s": round(b50, 6),
            "cur_p50_s": round(c50, 6),
            "base_total_s": round(float(b.get("total_s", 0.0)), 6),
            "cur_total_s": round(float(c.get("total_s", 0.0)), 6),
        }
        if b50 > 0:
            delta = 100.0 * (c50 - b50) / b50
            entry["delta_pct"] = round(delta, 2)
            entry["regressed"] = bool(delta > tolerance_pct)
        else:
            # Un-comparable baseline (zero-duration phase): report only.
            entry["delta_pct"] = None
            entry["regressed"] = False
        if entry["regressed"]:
            regressions.append(name)
        phases[name] = entry
    # Utilization keys (roofline section, when both sides carry one):
    # regression = a RELATIVE drop beyond tolerance. Directionality is
    # inverted vs phase times — higher utilization is better.
    util: dict[str, dict] = {}
    util_regressions: list[str] = []
    br = base.get("roofline", {}).get("phases", {})
    cr = cur.get("roofline", {}).get("phases", {})
    from mpit_tpu_torch.obs.roofline import UTIL_KEYS

    for name in sorted(set(br) & set(cr)):
        for key in UTIL_KEYS:
            b, c = br[name].get(key), cr[name].get(key)
            if not isinstance(b, (int, float)) or not isinstance(
                c, (int, float)
            ) or b <= 0:
                continue
            drop = 100.0 * (b - c) / b
            entry = {
                "base": round(float(b), 2),
                "cur": round(float(c), 2),
                "drop_pct": round(drop, 2),
                "regressed": bool(drop > tolerance_pct),
            }
            util[f"{name}.{key}"] = entry
            if entry["regressed"]:
                util_regressions.append(f"{name}.{key}")
    # Memory keys: peak held-bytes GROWTH beyond tolerance
    # is a regression (a capacity leak holds time steady while HBM
    # climbs); the minimum-headroom drop is reported for context. Only
    # numeric-on-both-sides — a snapshot without ledger data (a
    # non-serving workload) never gates vacuously.
    mem: dict[str, dict] = {}
    mem_regressions: list[str] = []
    bm = base.get("memory") or {}
    cm = cur.get("memory") or {}
    b_peak, c_peak = bm.get("held_peak_bytes"), cm.get("held_peak_bytes")
    if (
        isinstance(b_peak, (int, float))
        and isinstance(c_peak, (int, float))
        and b_peak > 0
    ):
        growth = 100.0 * (c_peak - b_peak) / b_peak
        entry = {
            "base": int(b_peak),
            "cur": int(c_peak),
            "growth_pct": round(growth, 2),
            "regressed": bool(growth > tolerance_pct),
        }
        mem["held_peak_bytes"] = entry
        if entry["regressed"]:
            mem_regressions.append("memory.held_peak_bytes")
    b_head = bm.get("kv_headroom_min_pct")
    c_head = cm.get("kv_headroom_min_pct")
    if isinstance(b_head, (int, float)) and isinstance(c_head, (int, float)):
        mem["kv_headroom_min_pct"] = {
            "base": round(float(b_head), 2),
            "cur": round(float(c_head), 2),
        }
    # Host-tier keys, same never-gate-vacuously rule: a
    # run without a host tier carries no host peak, so nothing gates.
    # Host-peak GROWTH is a spill leak (payloads granted at dispatch
    # and never released); restream bytes are reported for context.
    b_hp = bm.get("host_held_peak_bytes")
    c_hp = cm.get("host_held_peak_bytes")
    if (
        isinstance(b_hp, (int, float))
        and isinstance(c_hp, (int, float))
        and b_hp > 0
    ):
        growth = 100.0 * (c_hp - b_hp) / b_hp
        entry = {
            "base": int(b_hp),
            "cur": int(c_hp),
            "growth_pct": round(growth, 2),
            "regressed": bool(growth > tolerance_pct),
        }
        mem["host_held_peak_bytes"] = entry
        if entry["regressed"]:
            mem_regressions.append("memory.host_held_peak_bytes")
    b_rs = bm.get("restream_bytes")
    c_rs = cm.get("restream_bytes")
    if isinstance(b_rs, (int, float)) and isinstance(c_rs, (int, float)):
        mem["restream_bytes"] = {"base": int(b_rs), "cur": int(c_rs)}
    out = {
        "tolerance_pct": tolerance_pct,
        "phases": phases,
        "missing_phases": sorted(set(bp) - set(cp)),
        "new_phases": sorted(set(cp) - set(bp)),
        "regressions": regressions,
        "ok": not regressions and not util_regressions
        and not mem_regressions,
    }
    if util:
        out["utilization"] = util
        out["util_regressions"] = util_regressions
    if mem:
        out["memory"] = mem
        out["memory_regressions"] = mem_regressions
    return out
