"""Request lifecycle ledger: per-request causal events and tail
exemplars (the port of :mod:`mpit_tpu.obs.trace`).

Every request carries a :class:`TraceContext` and accrues typed causal
events at each decision seam: the scheduler's (enqueue, admission
verdict with its projection inputs, shed, slot bind, prefill chunks,
decode-tick membership, COW copies, preemption park and resume, spec
draft and accept, retire reason) and the fleet's (assign, prefill,
shipment, re-queue, done). Aggregate per-event-kind counters
are always on (mode ``aggregate`` or ``full``); full ledgers are
retained only for exemplars:

- the slowest-k requests per SLO window (k = ``exemplar_k``),
- any request alive during an ``slo_breach``/``anomaly`` instant
  (pinned via :meth:`Ledger.pin_inflight`, wired through
  ``Sentinel(on_note=...)``),
- any errored/truncated request.

Everything else drops its ledger at retire; only the counters remain.
From a retained ledger, :func:`attribute_latency` decomposes the
request's measured latency into queue-wait / prefill-compute /
decode-compute-share / parked / scheduler-gap components; the residual
is explicit (``scheduler_gap``), so the components reconcile against
the measured latency by construction.

A trace context serializes to canonical JSON — version-tagged, no
pickle, byte-identical when re-serialized — and ships over compat
(:func:`send_trace_context` / :func:`recv_trace_context`: length
prefixed, on dedicated tags of a duplicated communicator).
:func:`exemplar_trace_events` puts a retained exemplar's events on the
Chrome trace; :func:`collect_exemplars` and :func:`format_why_slow` are
``python -m mpit_tpu_torch.obs why-slow``'s back end.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import time
from typing import Any, Callable, Iterable, Mapping

TRACE_FORMAT = "mpit-obs-trace-ctx-v1"
LEDGER_FORMAT = "mpit-obs-ledger-v1"

# Trace-context shipment tags: readable labels in a reserved range; the
# duplicated communicator's own matching space does the isolating.
TAG_TRACE_HEADER = 0x0B5_101
TAG_TRACE_PAYLOAD = 0x0B5_102

#: Components reported by :func:`attribute_latency`, in display order.
ATTRIBUTION_COMPONENTS = (
    "queue_wait_s",
    "prefill_compute_s",
    "decode_compute_share_s",
    "parked_s",
    "scheduler_gap_s",
)


# ---------------------------------------------------------------------------
# Trace context (the propagation contract).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity a request carries across process boundaries.

    ``trace_id`` is assigned once at intake and never rewritten;
    ``origin_rank``/``seq`` make it reconstructible and collision-free
    without wall-clock or RNG (both are banned in deterministic paths).
    """

    rid: str
    trace_id: str
    origin_rank: int = 0
    seq: int = 0

    def to_bytes(self) -> bytes:
        """Canonical serialized form — stable key order, no whitespace.

        Canonicalization is what makes a round trip BYTE-identical
        rather than merely value-identical.
        """
        doc = {
            "format": TRACE_FORMAT,
            "rid": self.rid,
            "trace_id": self.trace_id,
            "origin_rank": self.origin_rank,
            "seq": self.seq,
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "TraceContext":
        doc = json.loads(bytes(data).decode())
        if doc.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"not a trace context (format={doc.get('format')!r})"
            )
        return cls(
            rid=doc["rid"],
            trace_id=doc["trace_id"],
            origin_rank=int(doc["origin_rank"]),
            seq=int(doc["seq"]),
        )


def send_trace_context(ctx: TraceContext, dest: int, *, comm=None) -> None:
    """Ship a trace context to ``dest`` over the compat simulator:
    length-prefixed on dedicated tags over a duplicated communicator; a
    throwaway thread-local recorder absorbs the shipment's own Send
    accounting, so the application's P2P counters stay clean."""
    import torch

    from mpit_tpu_torch.compat import simulator as sim
    from mpit_tpu_torch.obs import core

    ship = sim.Comm_dup(comm, key="obs-trace-context")
    payload = torch.frombuffer(bytearray(ctx.to_bytes()), dtype=torch.uint8)
    with core.local_recorder(core.Recorder()):
        sim.Send(torch.tensor([payload.numel()], dtype=torch.int64), dest,
                 tag=TAG_TRACE_HEADER, comm=ship)
        sim.Send(payload, dest, tag=TAG_TRACE_PAYLOAD, comm=ship)


def recv_trace_context(src: int, *, comm=None) -> TraceContext:
    """Receive a trace context shipped by :func:`send_trace_context`."""
    import torch

    from mpit_tpu_torch.compat import simulator as sim
    from mpit_tpu_torch.obs import core

    ship = sim.Comm_dup(comm, key="obs-trace-context")
    with core.local_recorder(core.Recorder()):
        hdr = torch.zeros(1, dtype=torch.int64)
        sim.Recv(hdr, src=src, tag=TAG_TRACE_HEADER, comm=ship)
        buf = torch.zeros(int(hdr[0]), dtype=torch.uint8)
        sim.Recv(buf, src=src, tag=TAG_TRACE_PAYLOAD, comm=ship)
    return TraceContext.from_bytes(buf.numpy().tobytes())


# ---------------------------------------------------------------------------
# Per-request ledger record.
# ---------------------------------------------------------------------------


class _RequestRecord:
    """One live request's accumulating ledger (internal)."""

    __slots__ = (
        "ctx", "begin_t", "events", "pins", "n_dropped", "attrs",
    )

    def __init__(self, ctx: TraceContext, begin_t: float, attrs: dict):
        self.ctx = ctx
        self.begin_t = begin_t
        self.events: list[tuple[str, float, dict]] = []
        self.pins: list[str] = []  # pin reasons ("slo_breach@12", ...)
        self.n_dropped = 0
        self.attrs = attrs


def attribute_latency(
    events: Iterable[tuple[str, float, Mapping[str, Any]]],
    *,
    submit_t: float,
    retire_t: float,
) -> dict[str, float]:
    """Decompose a request's latency into causal components.

    - ``queue_wait_s``: submit -> first ``slot_bind``.
    - ``prefill_compute_s``: sum of ``prefill_chunk`` tick walls.
    - ``decode_compute_share_s``: sum of ``decode_tick``/``spec_tick``
      walls the request was resident in (see module docstring for why
      the full tick wall is the right per-request cost).
    - ``parked_s``: sum of ``preempt_park`` -> next ``slot_bind``.
    - ``scheduler_gap_s``: explicit residual — resident time not
      covered by prefill/decode ticks (admission bookkeeping, gauge
      sweeps, other slots' exclusive work). Clamped at zero against
      float fuzz.

    The components sum to ``request_latency_s`` up to the clamp, so
    reconciliation holds by construction; ``reconciliation_pct``
    reports the achieved gap for the 5% acceptance pin.
    """
    first_bind = None
    park_t = None
    parked = 0.0
    prefill = 0.0
    decode = 0.0
    for kind, t, attrs in events:
        if kind == "slot_bind":
            if first_bind is None:
                first_bind = t
            if park_t is not None:
                parked += max(t - park_t, 0.0)
                park_t = None
        elif kind == "preempt_park":
            park_t = t
        elif kind == "prefill_chunk":
            prefill += float(attrs.get("dur_s", 0.0))
        elif kind in ("decode_tick", "spec_tick"):
            decode += float(attrs.get("dur_s", 0.0))
    if park_t is not None:  # parked at end of trace (never resumed)
        parked += max(retire_t - park_t, 0.0)
    latency = max(retire_t - submit_t, 0.0)
    if first_bind is None:  # never bound (shed, or still queued)
        queue_wait = latency
        resident = 0.0
    else:
        queue_wait = max(first_bind - submit_t, 0.0)
        resident = max(retire_t - first_bind, 0.0) - parked
    gap = max(resident - prefill - decode, 0.0)
    total = queue_wait + prefill + decode + parked + gap
    recon = 0.0 if latency <= 0 else abs(total - latency) / latency * 100.0
    return {
        "queue_wait_s": queue_wait,
        "prefill_compute_s": prefill,
        "decode_compute_share_s": decode,
        "parked_s": parked,
        "scheduler_gap_s": gap,
        "total_s": total,
        "request_latency_s": latency,
        "reconciliation_pct": recon,
    }


# ---------------------------------------------------------------------------
# The ledger registry.
# ---------------------------------------------------------------------------


class Ledger:
    """Registry of request ledgers with tail-exemplar retention.

    Modes:

    - ``"off"``: every entry point is a no-op (an A/B arm; a server
      constructed with ``ledger=None`` skips even the call).
    - ``"aggregate"``: per-event-kind counters only; no per-request
      event lists, nothing retained at retire.
    - ``"full"``: counters + per-request event lists + exemplar
      retention.

    Retention at :meth:`retire`: errored/truncated and pinned requests
    always keep their ledger; otherwise the request competes in its SLO
    window's slowest-k heap (losers drop). ``window_s`` buckets
    retire times so a long run keeps k exemplars per window, not k
    total.
    """

    MODES = ("off", "aggregate", "full")

    def __init__(
        self,
        *,
        mode: str = "full",
        exemplar_k: int = 8,
        window_s: float = 60.0,
        max_events_per_request: int = 4096,
        origin_rank: int = 0,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        if exemplar_k < 1:
            raise ValueError("exemplar_k must be >= 1")
        self.mode = mode
        self.exemplar_k = int(exemplar_k)
        self.window_s = float(window_s)
        self.max_events_per_request = int(max_events_per_request)
        self.origin_rank = int(origin_rank)
        self._clock = clock
        self._seq = 0
        self.counts: dict[str, int] = {}
        self._active: dict[str, _RequestRecord] = {}
        self._retained: dict[str, dict] = {}
        # window index -> [(latency, seq, rid)] min-heap of current top-k
        self._windows: dict[int, list[tuple[float, int, str]]] = {}
        self.pin_events: list[dict] = []
        self.retired = 0
        self.dropped_ledgers = 0
        self.dropped_events = 0

    # -- intake ------------------------------------------------------------

    def begin(self, rid, *, t: float | None = None, **attrs) -> TraceContext | None:
        """Open a ledger for ``rid`` and record the ``enqueue`` event."""
        if self.mode == "off":
            return None
        self._seq += 1
        ctx = TraceContext(
            rid=str(rid),
            trace_id=f"{self.origin_rank:x}-{self._seq:08x}",
            origin_rank=self.origin_rank,
            seq=self._seq,
        )
        if self.mode == "full":
            self._active[str(rid)] = _RequestRecord(
                ctx, self._clock() if t is None else t, dict(attrs)
            )
        self.event(rid, "enqueue", t=t, **attrs)
        return ctx

    def event(self, rid, kind: str, *, t: float | None = None, **attrs) -> None:
        """Record one causal event. Counters always; list in full mode."""
        if self.mode == "off":
            return
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.mode != "full":
            return
        rec = self._active.get(str(rid))
        if rec is None:
            return
        if len(rec.events) >= self.max_events_per_request:
            rec.n_dropped += 1
            self.dropped_events += 1
            return
        rec.events.append((kind, self._clock() if t is None else t, attrs))

    def context(self, rid) -> TraceContext | None:
        rec = self._active.get(str(rid))
        return rec.ctx if rec is not None else None

    # -- pinning (sentinel / SLO joinability) ------------------------------

    def pin_inflight(self, reason: str, *, step=None) -> list[str]:
        """Pin every in-flight request's ledger for retention.

        Wire as a ``Sentinel(on_note=...)`` callback (the scheduler
        does this) so an ``slo_breach``/``anomaly``
        instant and the requests alive when it fired become joinable.
        Returns the pinned rids (the breach-time in-flight set).
        """
        if self.mode != "full":
            return []
        tag = reason if step is None else f"{reason}@{step}"
        rids = sorted(self._active)
        for rid in rids:
            self._active[rid].pins.append(tag)
        self.pin_events.append({"reason": reason, "step": step, "rids": rids})
        return rids

    # -- retire + retention ------------------------------------------------

    def retire(
        self,
        rid,
        *,
        t: float | None = None,
        status: str = "completed",
        reason: str = "",
    ) -> None:
        """Close ``rid``'s ledger and decide exemplar retention."""
        if self.mode == "off":
            return
        self.retired += 1
        if self.mode != "full":
            return
        rec = self._active.pop(str(rid), None)
        if rec is None:
            return
        now = self._clock() if t is None else t
        latency = max(now - rec.begin_t, 0.0)
        errored = status in ("errored", "truncated")
        why: list[str] = []
        if errored:
            why.append(status)
        why.extend(f"pinned:{p}" for p in rec.pins)
        if not why:
            # Compete in this window's slowest-k. Heap of survivors;
            # the evicted loser drops its ledger (the memory bound).
            win = int(now // self.window_s) if self.window_s > 0 else 0
            heap = self._windows.setdefault(win, [])
            item = (latency, rec.ctx.seq, str(rid))
            if len(heap) < self.exemplar_k:
                heapq.heappush(heap, item)
            else:
                evicted = heapq.heappushpop(heap, item)
                if evicted[2] != str(rid):
                    self._drop_retained(evicted[2])
                else:  # fast retire: not a tail exemplar
                    self.dropped_ledgers += 1
                    return
            why.append("slowest_k")
        self._retained[str(rid)] = self._materialize(
            rec, latency=latency, retire_t=now, status=status,
            reason=reason, why=why,
        )

    def _drop_retained(self, rid: str) -> None:
        # Only drop a pure slowest-k retention; pinned/errored ledgers
        # survive eviction from the heap.
        ex = self._retained.get(rid)
        if ex is not None and ex["retained_because"] == ["slowest_k"]:
            del self._retained[rid]
            self.dropped_ledgers += 1

    def _materialize(
        self, rec: _RequestRecord, *, latency, retire_t, status, reason, why,
    ) -> dict:
        return {
            "rid": rec.ctx.rid,
            "trace_id": rec.ctx.trace_id,
            "status": status,
            "retire_reason": reason,
            "retained_because": why,
            "latency_s": latency,
            "submit_t": rec.begin_t,
            "retire_t": retire_t,
            "n_events": len(rec.events),
            "n_dropped_events": rec.n_dropped,
            "attrs": rec.attrs,
            "events": [
                [kind, t - rec.begin_t, attrs] for kind, t, attrs in rec.events
            ],
            "attribution": attribute_latency(
                rec.events, submit_t=rec.begin_t, retire_t=retire_t
            ),
        }

    # -- surfacing ---------------------------------------------------------

    def exemplars(self) -> list[dict]:
        """Retained ledgers (plus pinned still-active ones), worst first.

        A pinned request that never retires (run ended mid-flight)
        still surfaces — its breach-window membership is the whole
        point of the pin — with ``status="in_flight"`` and attribution
        up to now.
        """
        out = list(self._retained.values())
        for rid, rec in self._active.items():
            if rec.pins:
                now = self._clock()
                out.append(self._materialize(
                    rec, latency=max(now - rec.begin_t, 0.0), retire_t=now,
                    status="in_flight", reason="",
                    why=[f"pinned:{p}" for p in rec.pins],
                ))
        out.sort(key=lambda e: -e["latency_s"])
        return out

    def stats(self) -> dict:
        """Compact aggregate view (always cheap, every mode)."""
        return {
            "mode": self.mode,
            "exemplar_k": self.exemplar_k,
            "counts": dict(self.counts),
            "retired": self.retired,
            "active": len(self._active),
            "exemplars_retained": len(self._retained),
            "dropped_ledgers": self.dropped_ledgers,
            "dropped_events": self.dropped_events,
            "pins": len(self.pin_events),
        }

    def snapshot(self) -> dict:
        """Full serializable dump (the ``why-slow`` CLI's input shape)."""
        return {
            "format": LEDGER_FORMAT,
            **self.stats(),
            "pin_events": list(self.pin_events),
            "exemplars": self.exemplars(),
        }


# ---------------------------------------------------------------------------
# Perfetto surfacing.
# ---------------------------------------------------------------------------


def exemplar_trace_events(
    exemplar: Mapping[str, Any], *, pid: int = 0, tid: int = 0,
) -> list[dict]:
    """Chrome-format instants for one exemplar's ledger events, each
    carrying the ``rid`` (and ``trace_id``) arg, so they land on the
    request's rid-filterable lane next to its ``queue_wait`` /
    ``request_ttft`` / ``request_latency`` spans. Feed them to
    ``export_chrome_trace(..., extra_events=...)``. Timestamps are
    relative to the exemplar's own submit instant."""
    rid = exemplar.get("rid", "")
    base = float(exemplar.get("submit_t", 0.0)) * 1e6
    out = []
    for kind, t_rel, attrs in exemplar.get("events", []):
        args = {"rid": rid, **attrs}
        if exemplar.get("trace_id"):
            args["trace_id"] = exemplar["trace_id"]
        out.append({
            "name": f"ledger:{kind}",
            "ph": "i",
            "s": "t",
            "ts": base + float(t_rel) * 1e6,
            "pid": pid,
            "tid": tid,
            "cat": "ledger",
            "args": args,
        })
    return out


# ---------------------------------------------------------------------------
# why-slow forensics (the CLI's back end; its exit codes live in __main__).
# ---------------------------------------------------------------------------


def collect_exemplars(doc: Mapping[str, Any]) -> tuple[list[dict], str | None]:
    """Pull exemplars out of a ledger snapshot, a ``Server.stats()``
    dict (or the serving CLI's output, which carries it), or a
    BENCH_DETAIL.json (every workload's ``trace_forensics`` block).
    Returns ``(exemplars, error)``, worst first; ``error`` is set when
    the input is unusable (no ledger, no exemplars, or a ledger that
    dropped events: forensics over holes would misattribute)."""
    docs: list[Mapping[str, Any]] = []
    if doc.get("format") == LEDGER_FORMAT:
        docs.append(doc)
    elif "workloads" in doc:
        for _name, wl in sorted(doc.get("workloads", {}).items()):
            block = wl.get("trace_forensics") if isinstance(wl, Mapping) else None
            if isinstance(block, Mapping):
                docs.append(block)
    elif "exemplars" in doc:
        docs.append(doc)
    if not docs:
        return [], "no ledger exemplars found in input"
    exemplars: list[dict] = []
    for d in docs:
        if int(d.get("dropped_events", 0)) > 0:
            return [], (
                f"ledger truncated ({d.get('dropped_events')} dropped "
                "events) — forensics would misattribute; refusing"
            )
        exemplars.extend(d.get("exemplars", []))
    if not exemplars:
        return [], "input has a ledger block but zero retained exemplars"
    exemplars.sort(key=lambda e: -float(e.get("latency_s", 0.0)))
    return exemplars, None


def format_why_slow(exemplar: Mapping[str, Any]) -> str:
    """Render one exemplar as a lifeline and an attribution table."""
    lines = [
        f"why-slow: rid={exemplar.get('rid')} "
        f"trace={exemplar.get('trace_id')} "
        f"status={exemplar.get('status')} "
        f"latency={float(exemplar.get('latency_s', 0.0)) * 1e3:.2f}ms",
        f"retained because: {', '.join(exemplar.get('retained_because', []))}"
        + (
            f"  retire: {exemplar['retire_reason']}"
            if exemplar.get("retire_reason") else ""
        ),
        "",
        "attribution:",
    ]
    attr = exemplar.get("attribution", {})
    latency = float(attr.get("request_latency_s", 0.0)) or 1.0
    for comp in ATTRIBUTION_COMPONENTS:
        v = float(attr.get(comp, 0.0))
        lines.append(f"  {comp:24s} {v * 1e3:10.3f}ms  {v / latency * 100.0:5.1f}%")
    lines.append(
        f"  {'request_latency_s':24s} "
        f"{float(attr.get('request_latency_s', 0.0)) * 1e3:10.3f}ms  "
        f"(reconciles within {float(attr.get('reconciliation_pct', 0.0)):.2f}%)"
    )
    lines.append("")
    lines.append("lifeline:")
    for kind, t_rel, attrs in exemplar.get("events", []):
        detail = " ".join(f"{k}={v}" for k, v in attrs.items())
        lines.append(f"  +{float(t_rel) * 1e3:9.3f}ms  {kind:15s} {detail}")
    return "\n".join(lines)
