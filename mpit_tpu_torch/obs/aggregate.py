"""Cross-rank telemetry aggregation — the distributed flight recorder,
ported from :mod:`mpit_tpu.obs.aggregate` (its multi-process gather and
merged-trace file export wait for the multi-card bootstrap).

Each rank's :class:`~mpit_tpu_torch.obs.core.Recorder` is its own; the
interesting questions are cross-rank: which rank is the straggler, how
skewed are the phase times, what did the ranks send each other. This
module ships each rank's drained events to rank 0 and merges them there:

- :func:`gather_compat` — ranks of a compat job serialize their drained
  snapshot and Send it to rank 0 over the :mod:`mpit_tpu_torch.compat`
  tagged P2P path (length-prefixed, reserved tags, a duplicated
  communicator);
- :func:`merged_trace_events` — one Chrome-trace event list with a lane
  per rank (``pid = rank``);
- :func:`skew_report` — ``{phase: {max_rank, min_rank, skew_s,
  skew_pct, per_rank_s}}``: the per-phase straggler, named;
- :func:`merged_matrix` / :func:`reconcile_matrices` — the *measured*
  rank×rank P2P byte matrix, cross-checked against a modeled one;
- :func:`flight_record` — the merged artifact rank 0 keeps.

Serialization is plain JSON (version-tagged, the JAX package's format),
so no pickle.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np
import torch

from mpit_tpu_torch.obs import core
from mpit_tpu_torch.obs.export import snapshot_trace_events

_FORMAT = "mpit-obs-rank-snapshot-v1"

# Flight-recorder shipment tags. Isolation from application traffic
# comes from the DUPLICATED communicator (compat ``Comm_dup`` — its own
# matching space, un-stealable even by ANY_TAG wildcard receives); the
# distinct tags are readable labels and header/payload sequencing.
TAG_OBS_HEADER = 0x0B5_001
TAG_OBS_PAYLOAD = 0x0B5_002


# ---------------------------------------------------------------------------
# Snapshot serialization (Recorder.drain()/snapshot() dict <-> bytes).
# ---------------------------------------------------------------------------


def serialize_snapshot(snap: Mapping[str, Any]) -> bytes:
    """Version-tagged JSON bytes of a drained/snapshotted recorder."""
    doc = {
        "format": _FORMAT,
        "events": [
            [kind, name, t0, dur, tid, dict(attrs) if attrs else None]
            for kind, name, t0, dur, tid, attrs in snap["events"]
        ],
        "counters": [
            [name, list(akey), value]
            for (name, akey), value in snap["counters"].items()
        ],
        "gauges": [
            [name, list(akey), value]
            for (name, akey), value in snap["gauges"].items()
        ],
        "thread_names": {
            str(tid): name for tid, name in snap["thread_names"].items()
        },
        "dropped": snap.get("dropped", 0),
    }
    return json.dumps(doc, default=str).encode()


def deserialize_snapshot(payload: bytes) -> dict:
    """Inverse of :func:`serialize_snapshot` (back to the snapshot shape
    every exporter/summary consumer already reads)."""
    doc = json.loads(payload.decode())
    if doc.get("format") != _FORMAT:
        raise ValueError(
            f"not a rank snapshot (format={doc.get('format')!r})"
        )

    def _series(rows):
        return {
            (name, tuple(tuple(kv) for kv in akey)): value
            for name, akey, value in rows
        }

    return {
        "events": [
            (kind, name, t0, dur, tid, attrs)
            for kind, name, t0, dur, tid, attrs in doc["events"]
        ],
        "counters": _series(doc["counters"]),
        "gauges": _series(doc["gauges"]),
        "thread_names": {
            int(tid): name for tid, name in doc["thread_names"].items()
        },
        "dropped": doc.get("dropped", 0),
    }


def _take_snapshot(recorder: core.Recorder | None, drain: bool) -> dict:
    rec = recorder if recorder is not None else core.get_recorder()
    if rec is None:
        raise RuntimeError(
            "obs is disabled on this rank and no recorder was passed — "
            "install one (obs.enable() / obs.local_recorder()) before "
            "gathering"
        )
    return rec.drain() if drain else rec.snapshot()


# ---------------------------------------------------------------------------
# Transports.
# ---------------------------------------------------------------------------


def gather_compat(
    recorder: core.Recorder | None = None,
    *,
    root: int = 0,
    comm=None,
    drain: bool = True,
) -> dict[int, dict] | None:
    """Ship this rank's events to ``root`` over the compat simulator.

    Call from EVERY rank of a :func:`mpit_tpu_torch.compat.run` job (rank
    identity comes from the calling thread's simulator context). Non-root
    ranks Send a length header then the JSON payload on reserved tags
    and return ``None``; root Recvs from each peer in rank order and
    returns ``{rank: snapshot}`` including its own. ``drain=True``
    (default) clears each rank's buffer — the flight-recorder shipment
    is a consume, not a peek.
    """
    from mpit_tpu_torch.compat import simulator as sim

    rank = sim.Comm_rank(comm)
    size = sim.Comm_size(comm)
    snap = _take_snapshot(recorder, drain)
    # Isolation, both ways (the MPI library-traffic discipline):
    # - the shipment rides a DUPLICATED communicator (own matching
    #   space), so an application's outstanding ANY_TAG wildcard
    #   receive can never steal a snapshot payload (which would corrupt
    #   the app buffer AND hang the gather);
    # - a throwaway thread-local recorder absorbs the shipment's own
    #   Send/Recv accounting, so a SECOND periodic gather's P2P matrix
    #   reconciles against a model that only covers app traffic.
    ship = sim.Comm_dup(comm, key="obs-flight-recorder")
    with core.local_recorder(core.Recorder()):
        if rank != root:
            payload = torch.frombuffer(
                bytearray(serialize_snapshot(snap)), dtype=torch.uint8
            )
            sim.Send(
                torch.tensor([payload.numel()], dtype=torch.int64), root,
                tag=TAG_OBS_HEADER, comm=ship,
            )
            sim.Send(payload, root, tag=TAG_OBS_PAYLOAD, comm=ship)
            return None
        out = {root: snap}
        for src in range(size):
            if src == root:
                continue
            hdr = torch.zeros(1, dtype=torch.int64)
            sim.Recv(hdr, src=src, tag=TAG_OBS_HEADER, comm=ship)
            buf = torch.zeros(int(hdr[0]), dtype=torch.uint8)
            sim.Recv(buf, src=src, tag=TAG_OBS_PAYLOAD, comm=ship)
            out[src] = deserialize_snapshot(buf.numpy().tobytes())
    return out


# ---------------------------------------------------------------------------
# Merging: trace lanes, skew, matrices.
# ---------------------------------------------------------------------------


def merged_trace_events(per_rank: Mapping[int, Mapping]) -> list[dict]:
    """One Chrome-trace event list with a lane per rank (``pid=rank``)."""
    events: list[dict] = []
    for rank in sorted(per_rank):
        events.extend(
            snapshot_trace_events(
                per_rank[rank], pid=rank, pid_label=f"rank {rank}"
            )
        )
    return events


def _phase_totals(snap: Mapping) -> dict[str, float]:
    totals: dict[str, float] = {}
    for kind, name, _t0, dur, _tid, _attrs in snap["events"]:
        if kind == "X":
            totals[name] = totals.get(name, 0.0) + float(dur)
    return totals


def skew_report(per_rank: Mapping[int, Mapping]) -> dict:
    """Per-phase cross-rank skew: who is slowest, and by how much.

    ``{phase: {max_rank, min_rank, max_s, min_s, skew_s, skew_pct,
    per_rank_s}}``, where ``skew_pct = 100·(max−min)/max``. A phase a
    rank never entered counts as 0s for that rank only if SOME rank
    recorded it — absent-everywhere phases don't appear.
    """
    by_phase: dict[str, dict[int, float]] = {}
    for rank, snap in per_rank.items():
        for name, total in _phase_totals(snap).items():
            by_phase.setdefault(name, {})[rank] = total
    out = {}
    for phase, by_rank in sorted(by_phase.items()):
        full = {r: by_rank.get(r, 0.0) for r in per_rank}
        max_rank = max(full, key=lambda r: full[r])
        min_rank = min(full, key=lambda r: full[r])
        mx, mn = full[max_rank], full[min_rank]
        out[phase] = {
            "max_rank": max_rank,
            "min_rank": min_rank,
            "max_s": round(mx, 6),
            "min_s": round(mn, 6),
            "skew_s": round(mx - mn, 6),
            "skew_pct": round(100.0 * (mx - mn) / mx, 2) if mx else 0.0,
            "per_rank_s": {r: round(v, 6) for r, v in sorted(full.items())},
        }
    return out


def merged_matrix(
    per_rank: Mapping[int, Mapping],
    nranks: int | None = None,
    *,
    counter: str = "p2p_send_bytes",
) -> np.ndarray:
    """The MEASURED rank×rank byte matrix from per-rank counters.

    Each rank's recorder carries only its own sends (send-side
    accounting on the sender's thread-local recorder); the merge is the
    global picture. ``M[src, dst]`` = bytes src sent dst. ``nranks``
    defaults to covering every rank KEY and every src/dst OBSERVED in
    the counters — an incomplete gather (a rank dead before the gather)
    must widen the matrix, not silently drop the surviving ranks'
    traffic toward the missing peer. An explicit ``nranks`` is a
    deliberate clamp: out-of-range cells are then dropped.
    """
    entries: list[tuple[int, int, float]] = []
    for snap in per_rank.values():
        for (name, akey), value in snap["counters"].items():
            if name != counter:
                continue
            attrs = dict(akey)
            entries.append((int(attrs["src"]), int(attrs["dst"]), value))
    if nranks is None:
        mx = max(per_rank, default=-1)
        for src, dst, _v in entries:
            mx = max(mx, src, dst)
        nranks = mx + 1
    m = np.zeros((nranks, nranks), dtype=np.float64)
    for src, dst, value in entries:
        if src < nranks and dst < nranks:
            m[src, dst] += value
    return m


def reconcile_matrices(
    measured, modeled, *, tolerance_pct: float = 5.0
) -> dict:
    """Cross-check the measured P2P matrix against the modeled one.

    Per-cell relative error against the larger of the two values (cells
    zero in both agree exactly). ``ok`` iff the worst cell is within
    ``tolerance_pct``.
    """
    m = np.asarray(measured, np.float64)
    d = np.asarray(modeled, np.float64)
    if m.shape != d.shape:
        raise ValueError(f"shape mismatch: measured {m.shape} vs modeled {d.shape}")
    denom = np.maximum(np.maximum(np.abs(m), np.abs(d)), 1e-12)
    rel = np.abs(m - d) / denom
    rel[(m == 0) & (d == 0)] = 0.0
    worst = np.unravel_index(int(np.argmax(rel)), rel.shape) if rel.size else (0, 0)
    max_rel_pct = float(100.0 * rel.max()) if rel.size else 0.0
    return {
        "ok": bool(max_rel_pct <= tolerance_pct),
        "tolerance_pct": tolerance_pct,
        "max_rel_err_pct": round(max_rel_pct, 4),
        "max_abs_err_bytes": float(np.abs(m - d).max()) if rel.size else 0.0,
        "worst_cell": [int(worst[0]), int(worst[1])],
    }


def flight_record(
    per_rank: Mapping[int, Mapping],
    *,
    modeled_matrix=None,
    tolerance_pct: float = 5.0,
    counter: str = "p2p_send_bytes",
) -> dict:
    """The merged flight-recorder artifact rank 0 persists.

    Skew report + headline straggler (the rank atop the phase with the
    largest absolute skew), the measured P2P matrix, and — when a
    modeled matrix is supplied — its reconciliation verdict.
    """
    skew = skew_report(per_rank)
    out: dict[str, Any] = {"ranks": sorted(per_rank), "skew": skew}
    if skew:
        phase = max(skew, key=lambda p: skew[p]["skew_s"])
        out["straggler"] = {
            "rank": skew[phase]["max_rank"],
            "phase": phase,
            "skew_s": skew[phase]["skew_s"],
            "skew_pct": skew[phase]["skew_pct"],
        }
    measured = merged_matrix(per_rank, counter=counter)
    out["p2p_measured_bytes"] = measured.tolist()
    if modeled_matrix is not None:
        out["p2p_modeled_bytes"] = np.asarray(modeled_matrix).tolist()
        out["p2p_reconciliation"] = reconcile_matrices(
            measured, modeled_matrix, tolerance_pct=tolerance_pct
        )
    dropped = sum(s.get("dropped", 0) for s in per_rank.values())
    if dropped:
        out["dropped_events"] = dropped
    return out
