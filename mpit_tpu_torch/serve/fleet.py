"""Disaggregated serving fleet: router + prefill/decode workers, the
port of :mod:`mpit_tpu.serve.fleet`.

The single-process :class:`~mpit_tpu_torch.serve.scheduler.Server` caps
concurrency at one engine's slots and pages. The fleet replays the
paper's pserver request loop as inference, on the compat layer
(:mod:`mpit_tpu_torch.compat`: every rank is a thread of this process):

- **rank 0, the router**: admits requests fleet-wide with the projected
  TTFT (:class:`~mpit_tpu_torch.serve.policy.TTFTProjector` over a
  :class:`~mpit_tpu_torch.obs.stream.StreamRegistry` fed by worker tick
  reports), assigns each to a free prefill worker and the least-loaded
  live decode worker, and owns liveness: a ``Probe(timeout=)`` loop +
  lease sweep, so a dead worker's in-flight requests re-queue to a
  survivor instead of hanging.
- **ranks 1..P, prefill workers**: run prefill on their own engine
  (slot 0, reset per request; a paged engine replays the scheduler's
  chunk widths) and ship the finished KV rows to the assigned decode
  worker as a length-prefixed :mod:`~mpit_tpu_torch.serve.shipment` on
  the dedicated ``Comm_dup("fleet-kv")`` channel. On the card the
  payload never leaves it: the compat layer moves it through the CUDA
  copy kernel.
- **ranks P+1..P+D, decode workers**: admit shipments into their own
  slots (paged: an all-or-nothing ``allocator.admit``; dense: a slot of
  the free deque, granted in the engine's memory ledger), inject the KV
  rows, and stream decode ticks until EOS/max-tokens, reporting
  completions to the router; each reports its ledger's held bytes.

Every worker runs a heartbeat thread (bind_thread + the rank's own
recorder); a killed worker (``FaultPlan.kill_at``) stops its
heartbeats, its lease expires at the router, and its in-flight requests
re-dispatch. Greedy outputs equal the single-engine run because prefill
and decode are deterministic per request; the decode tick's batch is
the engine's fixed slot count in both. Every rank gathers its flight
recorder at the end of the job (killed workers too); the router
attaches the skew report and the merged P2P matrix, on which KV
shipment bytes ride.

Control tags live in the 41-46 block on ``Comm_dup("fleet-ctl")``
(shipments 61-63 on their own channel — disjoint matching spaces).
Control messages are length-prefixed JSON: an ``int64[1]`` byte count
then the ``uint8`` payload on the same (src, tag) — compat's per-(src,
tag) FIFO makes the pair safe even under ``ANY_SOURCE`` probing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from mpit_tpu_torch import compat as mpiT
from mpit_tpu_torch.obs import aggregate
from mpit_tpu_torch.obs import core as _obs
from mpit_tpu_torch.obs.stream import StreamRegistry
from mpit_tpu_torch.obs.trace import Ledger
from mpit_tpu_torch.serve.policy import TTFTProjector
from mpit_tpu_torch.serve.shipment import (
    SHIPMENT_CHANNEL,
    KVShipment,
    inject_shipment,
    recv_shipment,
    send_shipment,
)

__all__ = [
    "CTL_CHANNEL",
    "FleetConfig",
    "ROUTER_RANK",
    "parse_fleet_spec",
    "run_fleet",
]

ROUTER_RANK = 0
CTL_CHANNEL = "fleet-ctl"

# Control tags (41-46; shipments use 61-63 on their own channel).
TAG_ASSIGN = 41     # router -> prefill: one request assignment (json)
TAG_PREFILLED = 42  # prefill -> router: prefill done + tick cost (json)
TAG_SHIP = 43       # prefill -> decode: shipment notify (json; KV follows)
TAG_DONE = 44       # decode -> router: completion (json)
TAG_STOP = 45       # router -> worker: drain and exit (int32[1])
TAG_HB = 46         # worker -> router: heartbeat (int32[1] = progress)

_TAG_NAMES = {
    TAG_ASSIGN: "assign", TAG_PREFILLED: "prefilled", TAG_SHIP: "ship",
    TAG_DONE: "done", TAG_STOP: "stop", TAG_HB: "hb",
}


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology + liveness knobs. ``admission_ttft_s`` is the
    router's shed threshold on the projected TTFT (<= 0 = admit
    everything; the projector abstains while cold either way)."""

    prefill: int = 1
    decode: int = 1
    heartbeat_s: float = 0.05
    lease_s: float = 0.5
    admission_ttft_s: float = 0.0
    job_timeout_s: float = 120.0

    def __post_init__(self):
        if self.prefill < 1 or self.decode < 1:
            raise ValueError(
                f"fleet needs >=1 prefill and >=1 decode worker, got "
                f"prefill={self.prefill} decode={self.decode}"
            )
        if self.lease_s <= self.heartbeat_s:
            raise ValueError(
                f"lease_s ({self.lease_s}) must exceed heartbeat_s "
                f"({self.heartbeat_s}) or every worker flaps"
            )

    @property
    def nranks(self) -> int:
        return 1 + self.prefill + self.decode

    def role_of(self, rank: int) -> str:
        if rank == ROUTER_RANK:
            return "router"
        return "prefill" if rank <= self.prefill else "decode"


_SPEC_KEYS = {
    "prefill": int, "decode": int, "heartbeat_s": float, "lease_s": float,
    "admission_ttft_s": float, "job_timeout_s": float,
}


def parse_fleet_spec(text: str) -> FleetConfig:
    """``"prefill=2,decode=2[,lease_s=0.5,...]"`` -> FleetConfig."""
    kw: dict[str, Any] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"fleet spec field {part!r} is not key=value "
                f"(known keys: {sorted(_SPEC_KEYS)})"
            )
        key, val = part.split("=", 1)
        key = key.strip()
        conv = _SPEC_KEYS.get(key)
        if conv is None:
            raise ValueError(
                f"unknown fleet spec key {key!r} "
                f"(known: {sorted(_SPEC_KEYS)})"
            )
        kw[key] = conv(val)
    return FleetConfig(**kw)


# ---------------------------------------------------------------------------
# Length-prefixed JSON control frames.
# ---------------------------------------------------------------------------


def _send_json(obj: dict, dest: int, tag: int, comm) -> None:
    payload = torch.frombuffer(bytearray(json.dumps(obj).encode("utf-8")),
                               dtype=torch.uint8)
    mpiT.Send(torch.tensor([payload.numel()], dtype=torch.int64), dest=dest,
              tag=tag, comm=comm)
    mpiT.Send(payload, dest=dest, tag=tag, comm=comm)


def _recv_json(src: int, tag: int, comm) -> dict:
    """Both frames queue on one (src, tag) stream — the length prefix
    is already in flight when the caller's Probe saw it, so neither
    Recv can block against a live sender."""
    n = torch.empty((1,), dtype=torch.int64)
    mpiT.Recv(n, src=src, tag=tag, comm=comm)
    payload = torch.empty((int(n[0]),), dtype=torch.uint8)
    mpiT.Recv(payload, src=src, tag=tag, comm=comm)
    return json.loads(payload.numpy().tobytes().decode("utf-8"))


def _drain_unexpected(st, comm) -> None:
    """The pserver rule, sharpened: an unexpected tag is a protocol
    bug — fail loudly (the job aborts, so the unconsumed frame dies
    with the wire; we cannot even size a drain buffer without knowing
    the rogue sender's dtype)."""
    raise RuntimeError(
        f"fleet: unexpected tag {st.tag} from rank {st.source} "
        f"({st.count} elements)"
    )


# ---------------------------------------------------------------------------
# Heartbeats.
# ---------------------------------------------------------------------------


def _start_heartbeats(rank: int, ctl, cfg: FleetConfig, progress):
    """Daemon thread Sending TAG_HB every ``heartbeat_s``. Returns the
    stop event; the worker sets it before exiting (a killed worker
    MUST stop beating or its lease never expires and its in-flight
    requests never re-queue)."""
    stop = threading.Event()
    rank_rec = _obs.get_recorder()

    def _beat():
        # Adopt the worker's rank identity (compat.bind_thread) AND its
        # recorder, so heartbeat sends carry the right source and are
        # charged to this rank's event stream.
        mpiT.bind_thread(rank, ctl)
        rec_ctx = (
            _obs.local_recorder(rank_rec) if rank_rec is not None
            else contextlib.nullcontext()
        )
        with rec_ctx:
            while not stop.wait(cfg.heartbeat_s):
                mpiT.Send(
                    torch.tensor([progress()], dtype=torch.int32),
                    dest=ROUTER_RANK, tag=TAG_HB, comm=ctl,
                )

    threading.Thread(
        target=_beat, daemon=True, name=f"fleet-hb-{rank}"
    ).start()
    return stop


# ---------------------------------------------------------------------------
# Router.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _WorkerSlot:
    role: str
    last_hb: float
    active: bool = True
    busy_rid: str | None = None      # prefill workers: current assignment
    inflight: set = dataclasses.field(default_factory=set)


def _fleet_router(requests, cfg: FleetConfig, ctl) -> dict:
    """Rank 0: admission, routing, liveness, completion collection."""
    registry = StreamRegistry()
    projector = TTFTProjector(registry)
    ledger = Ledger(mode="aggregate", origin_rank=ROUTER_RANK)

    prefill_ranks = list(range(1, 1 + cfg.prefill))
    decode_ranks = list(range(1 + cfg.prefill, cfg.nranks))
    now = time.monotonic()
    slots = {
        r: _WorkerSlot(cfg.role_of(r), now)
        for r in prefill_ranks + decode_ranks
    }

    reqs = {str(r.rid): r for r in requests}
    if len(reqs) != len(requests):
        raise ValueError("fleet requests must carry unique rids")
    pending = deque(str(r.rid) for r in requests)
    decode_of: dict[str, int] = {}
    results: dict[str, list[int]] = {}
    shed: list[str] = []
    events: list[tuple] = []
    requeues = 0
    projected_last: float | None = None

    def _active(role: str) -> list[int]:
        return [
            r for r in (prefill_ranks if role == "prefill" else decode_ranks)
            if slots[r].active
        ]

    def _note(kind: str, rank: int, **extra):
        events.append((kind, rank, *extra.values()))
        _obs.instant(f"fleet_{kind}", rank=rank, **extra)

    def _gauges():
        for r, s in slots.items():
            _obs.gauge("fleet_inflight", len(s.inflight), rank=r)
        registry.set_gauge("fleet_pending", len(pending))

    order_index = {rid: i for i, rid in enumerate(pending)}

    def _requeue_one(rid: str, from_rank: int):
        nonlocal requeues
        if rid in results or rid in shed:
            return
        pending.appendleft(rid)
        decode_of.pop(rid, None)
        ledger.event(rid, "fleet_requeue", from_rank=from_rank)
        requeues += 1

    def _requeue_inflight(rank: int):
        s = slots[rank]
        # Front of the queue keeps submission order: appendleft in
        # REVERSE submission order so the earliest rid re-dispatches
        # first.
        for rid in sorted(
            s.inflight, key=lambda r: order_index.get(r, 0), reverse=True
        ):
            _requeue_one(rid, rank)
        s.inflight.clear()
        s.busy_rid = None

    # An eviction is a *suspicion*, not a death certificate: a live
    # worker descheduled past the lease (host-wide CPU stall) rejoins
    # on its next heartbeat. So an empty decode roster only aborts the
    # job after staying empty a FULL extra lease window — long enough
    # for every spuriously-evicted survivor to beat again, short
    # enough that a genuinely dead fleet still fails fast.
    decode_dead_since: list[float | None] = [None]

    def _sweep(t_now: float):
        for rank, s in slots.items():
            age = t_now - s.last_hb
            _obs.gauge("fleet_heartbeat_age_s", round(age, 4), rank=rank)
            if s.active and age > cfg.lease_s:
                s.active = False
                _note("evicted", rank, heartbeat_age_s=round(age, 4))
                _requeue_inflight(rank)
        if _active("decode") or not (pending or _unfinished()):
            decode_dead_since[0] = None
        elif decode_dead_since[0] is None:
            decode_dead_since[0] = t_now
        elif t_now - decode_dead_since[0] > cfg.lease_s:
            raise RuntimeError(
                "fleet: every decode worker's lease expired with "
                f"{len(pending)} request(s) outstanding — nothing left "
                "to re-queue onto"
            )

    def _unfinished() -> int:
        return len(reqs) - len(results) - len(shed)

    def _dispatch():
        nonlocal projected_last
        while pending:
            free_pf = [
                r for r in _active("prefill") if slots[r].busy_rid is None
            ]
            live_dec = _active("decode")
            if not free_pf or not live_dec:
                return
            rid = pending.popleft()
            req = reqs[rid]
            projected_last = projector.projected_ttft_s(len(pending))
            if (
                cfg.admission_ttft_s > 0.0
                and projected_last is not None
                and projected_last > cfg.admission_ttft_s
            ):
                shed.append(rid)
                registry.inc("fleet_shed")
                ledger.event(rid, "fleet_shed",
                             projected_ttft_s=projected_last)
                continue
            pf = free_pf[0]
            dec = min(live_dec, key=lambda r: (len(slots[r].inflight), r))
            slots[pf].busy_rid = rid
            slots[pf].inflight.add(rid)
            slots[dec].inflight.add(rid)
            decode_of[rid] = dec
            ledger.event(rid, "fleet_assign", prefill=pf, decode=dec)
            _send_json(
                {
                    "rid": rid,
                    "prompt": [int(t) for t in req.prompt],
                    "max_new_tokens": int(req.max_new_tokens),
                    "temperature": float(req.temperature),
                    "top_k": int(req.top_k),
                    "eos_id": None if req.eos_id is None else int(req.eos_id),
                    "decode": dec,
                },
                pf, TAG_ASSIGN, ctl,
            )

    probe_timeout = max(min(cfg.lease_s / 4, cfg.heartbeat_s), 0.005)
    while _unfinished():
        _dispatch()
        _gauges()
        try:
            with _obs.span("fleet:probe_wait"):
                st = mpiT.Probe(
                    mpiT.ANY_SOURCE, mpiT.ANY_TAG, comm=ctl,
                    timeout=probe_timeout,
                )
        except mpiT.CompatTimeoutError:
            _sweep(time.monotonic())
            continue
        now = time.monotonic()
        _obs.counter(
            "fleet_msgs", 1, kind=_TAG_NAMES.get(st.tag, str(st.tag))
        )
        if st.tag == TAG_HB:
            mpiT.Recv(torch.empty((1,), dtype=torch.int32), src=st.source,
                      tag=TAG_HB, comm=ctl)
            s = slots[st.source]
            s.last_hb = now
            if not s.active:
                s.active = True
                _note("rejoined", st.source)
        elif st.tag == TAG_PREFILLED:
            msg = _recv_json(st.source, TAG_PREFILLED, ctl)
            rid = msg["rid"]
            registry.observe("prefill_tick", float(msg["prefill_s"]))
            s = slots[st.source]
            if s.busy_rid == rid:
                s.busy_rid = None
            s.inflight.discard(rid)
            ledger.event(rid, "fleet_prefilled", rank=st.source,
                         bytes=int(msg.get("bytes", 0)))
            dec = decode_of.get(rid)
            if dec is not None and not slots[dec].active:
                # Shipped into a dead worker's void — re-queue now
                # rather than wait for the sweep to notice.
                slots[dec].inflight.discard(rid)
                _requeue_one(rid, dec)
        elif st.tag == TAG_DONE:
            msg = _recv_json(st.source, TAG_DONE, ctl)
            rid = msg["rid"]
            slots[st.source].inflight.discard(rid)
            if rid in results:
                continue  # duplicate from an evicted-then-finished worker
            results[rid] = [int(t) for t in msg["tokens"]]
            for s_tick in msg.get("decode_tick_s", []):
                registry.observe("decode_tick", float(s_tick))
            registry.inc("fleet_completed")
            ledger.event(rid, "fleet_done", rank=st.source,
                         ticks=int(msg.get("ticks", 0)))
        elif st.tag == TAG_STOP:
            # Workers never send STOP; treat as protocol corruption.
            _drain_unexpected(st, ctl)
        else:
            _drain_unexpected(st, ctl)
        _sweep(now)

    for rank in prefill_ranks + decode_ranks:
        mpiT.Send(torch.tensor([0], dtype=torch.int32), dest=rank,
                  tag=TAG_STOP, comm=ctl)
    evictions = sum(1 for e in events if e[0] == "evicted")
    return {
        "role": "router",
        "completed": results,
        "shed": shed,
        "events": events,
        "evictions": evictions,
        "requeues": requeues,
        "projected_ttft_s_last": projected_last,
        "ledger_counts": dict(ledger.counts),
    }


# ---------------------------------------------------------------------------
# Prefill worker.
# ---------------------------------------------------------------------------


def _prefill_one(engine, msg: dict, ledger) -> tuple[KVShipment, float]:
    """Run one request's prefill on slot 0 of a freshly-reset engine
    and package the shipment. Paged engines replay the scheduler's
    chunked-prefill host loop exactly (same chunk widths → identical
    KV rows → the decode side bit-matches the single-engine run);
    dense engines take the whole prompt in one call."""
    rid = msg["rid"]
    prompt = [int(t) for t in msg["prompt"]]
    engine.reset()
    S = engine.slots
    temp = np.zeros((S,), np.float32)
    topk = np.zeros((S,), np.int32)
    temp[0] = float(msg["temperature"])
    topk[0] = int(msg["top_k"])
    t0 = time.perf_counter()
    if engine.paged:
        plan = engine.allocator.admit(0, prompt, 1)
        if plan is None:
            raise RuntimeError(
                f"fleet prefill worker cannot page prompt of {len(prompt)} "
                "tokens — size the worker's kv_pages for the trace"
            )
        w = engine.prefill_chunk
        base, first = 0, None
        while base < len(prompt):
            n = min(w, len(prompt) - base)
            tk = np.zeros((S, w), np.int32)
            tk[0, :n] = prompt[base : base + n]
            ba = np.zeros((S,), np.int32)
            ba[0] = base
            cl = np.zeros((S,), np.int32)
            cl[0] = n
            fl = np.zeros((S,), np.int32)
            sm = np.zeros((S,), bool)
            sm[0] = base + n == len(prompt)
            out = engine.prefill_paged(tk, ba, cl, fl, sm, temp, topk)
            if sm[0]:
                first = int(out[0])
            base += n
    else:
        if len(prompt) > engine.prefill_len:
            raise RuntimeError(
                f"fleet dense prefill worker caps prompts at "
                f"{engine.prefill_len} tokens, got {len(prompt)}"
            )
        toks = np.zeros((S, engine.prefill_len), np.int32)
        toks[0, : len(prompt)] = prompt
        lens = np.ones((S,), np.int32)
        lens[0] = len(prompt)
        admit = np.zeros((S,), bool)
        admit[0] = True
        first = int(engine.prefill(toks, lens, admit, temp, topk)[0])
    prefill_s = time.perf_counter() - t0
    k, v = engine.export_kv_rows(0, len(prompt))
    ledger.event(rid, "fleet_prefill", dur_s=prefill_s)
    return KVShipment(
        rid=rid,
        prompt=prompt,
        first_token=first,
        length=len(prompt),
        max_new_tokens=int(msg["max_new_tokens"]),
        temperature=float(msg["temperature"]),
        top_k=int(msg["top_k"]),
        eos_id=msg["eos_id"],
        quantized=hasattr(k, "q"),
        k=k,
        v=v,
    ), prefill_s


def _prefill_worker(rank, engine_factory, cfg: FleetConfig, fault_plan,
                    ctl, kv):
    ledger = Ledger(mode="aggregate", origin_rank=rank)
    step = 0
    # Heartbeats start BEFORE the engine builds: a build (weights, kernel
    # libraries) can outlast the lease, and a worker evicted while
    # warming up never serves.
    hb_stop = _start_heartbeats(rank, ctl, cfg, lambda: step)
    processed, ship_bytes, killed = 0, 0, False
    try:
        engine = engine_factory("prefill", rank)
        while True:
            if fault_plan is not None:
                fault_plan.step_action(rank, step)
            try:
                st = mpiT.Probe(
                    ROUTER_RANK, mpiT.ANY_TAG, comm=ctl,
                    timeout=cfg.heartbeat_s,
                )
            except mpiT.CompatTimeoutError:
                continue
            if st.tag == TAG_STOP:
                mpiT.Recv(torch.empty((1,), dtype=torch.int32),
                          src=ROUTER_RANK, tag=TAG_STOP, comm=ctl)
                break
            if st.tag != TAG_ASSIGN:
                _drain_unexpected(st, ctl)
            msg = _recv_json(ROUTER_RANK, TAG_ASSIGN, ctl)
            with _obs.span("fleet:prefill", rid=msg["rid"]):
                ship, prefill_s = _prefill_one(engine, msg, ledger)
            dec = int(msg["decode"])
            # KV frames go out BEFORE the notify: the decode worker's
            # recv_shipment finds them already FIFO-queued.
            nbytes = send_shipment(ship, dec, kv, ledger=ledger)
            _send_json({"rid": ship.rid, "src": rank}, dec, TAG_SHIP, ctl)
            _send_json(
                {
                    "rid": ship.rid,
                    "decode": dec,
                    "prefill_s": prefill_s,
                    "bytes": nbytes,
                },
                ROUTER_RANK, TAG_PREFILLED, ctl,
            )
            ship_bytes += nbytes
            processed += 1
            step += 1
    except mpiT.ReplicaKilled as death:
        killed = True
        _obs.instant("fleet_worker_killed", rank=rank, step=death.step)
    finally:
        hb_stop.set()
    return {
        "role": "prefill",
        "rank": rank,
        "worker_id": f"prefill-{rank}",
        "processed": processed,
        "ship_bytes": ship_bytes,
        "killed": killed,
        "ledger_counts": dict(ledger.counts),
    }


# ---------------------------------------------------------------------------
# Decode worker.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DecodeLive:
    rid: str
    tokens: list
    max_new_tokens: int
    eos_id: int | None
    temperature: float
    top_k: int
    tick_s: list


def _decode_worker(rank, engine_factory, cfg: FleetConfig, fault_plan,
                   ctl, kv):
    ledger = Ledger(mode="aggregate", origin_rank=rank)
    ticks = 0
    # Heartbeats first, engine second — same warm-up rule as prefill.
    hb_stop = _start_heartbeats(rank, ctl, cfg, lambda: ticks)
    engine = engine_factory("decode", rank)
    S = engine.slots
    free = deque(range(S))
    live: dict[int, _DecodeLive] = {}
    backlog: deque[KVShipment] = deque()
    completed, killed, stop = 0, False, False

    def _finish(slot: int):
        nonlocal completed
        lv = live.pop(slot)
        if engine.paged:
            engine.allocator.free_slot(slot)
        else:
            engine.memledger.free("kv_slots", engine.slot_bytes, owner=lv.rid, kind="retire")
        engine.memledger.forget(lv.rid)
        free.append(slot)
        _send_json(
            {
                "rid": lv.rid,
                "tokens": lv.tokens,
                "ticks": len(lv.tick_s),
                "decode_tick_s": lv.tick_s,
            },
            ROUTER_RANK, TAG_DONE, ctl,
        )
        ledger.event(lv.rid, "fleet_decode_done", tokens=len(lv.tokens))
        completed += 1

    def _admit(ship: KVShipment) -> bool:
        if not free:
            return False
        slot = free[0]
        if engine.paged:
            plan = engine.allocator.admit(
                slot, ship.prompt, ship.max_new_tokens, owner=ship.rid, tick=ticks,
            )
            if plan is None:
                return False  # pool full — stays in backlog
        else:
            # A dense slot's bytes, granted in the engine's memory ledger
            # as the single Server grants them.
            engine.memledger.grant("kv_slots", engine.slot_bytes, owner=ship.rid,
                                   tick=ticks, kind="admit")
        free.popleft()
        inject_shipment(engine, slot, ship, ledger=ledger)
        live[slot] = _DecodeLive(
            rid=ship.rid,
            tokens=[int(ship.first_token)],
            max_new_tokens=int(ship.max_new_tokens),
            eos_id=ship.eos_id,
            temperature=float(ship.temperature),
            top_k=int(ship.top_k),
            tick_s=[],
        )
        if (
            len(live[slot].tokens) >= live[slot].max_new_tokens
            or (ship.eos_id is not None
                and int(ship.first_token) == int(ship.eos_id))
        ):
            _finish(slot)
        return True

    try:
        while not stop or live or backlog:
            # Drain control frames without starving live decodes.
            timeout = 0.001 if (live or backlog) else cfg.heartbeat_s
            while True:
                try:
                    st = mpiT.Probe(
                        mpiT.ANY_SOURCE, mpiT.ANY_TAG, comm=ctl,
                        timeout=timeout,
                    )
                except mpiT.CompatTimeoutError:
                    break
                if st.tag == TAG_STOP:
                    mpiT.Recv(torch.empty((1,), dtype=torch.int32),
                              src=st.source, tag=TAG_STOP, comm=ctl)
                    stop = True
                elif st.tag == TAG_SHIP:
                    note = _recv_json(st.source, TAG_SHIP, ctl)
                    ship = recv_shipment(
                        int(note["src"]), kv,
                        timeout=max(cfg.lease_s * 10, 1.0), ledger=ledger,
                        device=engine.device,
                    )
                    backlog.append(ship)
                else:
                    _drain_unexpected(st, ctl)
                timeout = 0.001
                if stop:
                    break
            for _ in range(len(backlog)):
                if not _admit(backlog[0]):
                    break
                backlog.popleft()
            if backlog and not live and len(free) == S:
                # An empty engine refused the shipment — no amount of
                # draining will ever fit it; fail instead of spinning.
                raise RuntimeError(
                    f"fleet decode worker {rank}: shipment for "
                    f"{backlog[0].rid!r} ({backlog[0].length} rows + "
                    f"{backlog[0].max_new_tokens} new) cannot fit an "
                    "idle engine — size kv_pages/max_len for the trace"
                )
            if not live:
                if stop and not backlog:
                    break
                continue
            if fault_plan is not None:
                fault_plan.step_action(rank, ticks)
            active = np.zeros((S,), bool)
            temp = np.zeros((S,), np.float32)
            topk = np.zeros((S,), np.int32)
            for slot, lv in live.items():
                active[slot] = True
                temp[slot] = lv.temperature
                topk[slot] = lv.top_k
            t0 = time.perf_counter()
            with _obs.span("fleet:decode_tick", live=len(live)):
                nxt = engine.decode(active, temp, topk)
            dt = time.perf_counter() - t0
            ticks += 1
            for slot in sorted(live):
                lv = live[slot]
                tok = int(nxt[slot])
                lv.tokens.append(tok)
                lv.tick_s.append(dt / max(len(live), 1))
                if len(lv.tokens) >= lv.max_new_tokens or (
                    lv.eos_id is not None and tok == int(lv.eos_id)
                ):
                    _finish(slot)
    except mpiT.ReplicaKilled as death:
        killed = True
        _obs.instant("fleet_worker_killed", rank=rank, step=death.step)
    finally:
        hb_stop.set()
    ml = engine.memledger
    return {
        "role": "decode",
        "rank": rank,
        "worker_id": f"decode-{rank}",
        "completed": completed,
        "ticks": ticks,
        "killed": killed,
        "ledger_counts": dict(ledger.counts),
        # The engine's memory ledger: slots (or pages) granted and freed
        # by this worker; a clean worker holds none of them at the end.
        "memory": {"held_bytes": int(ml.held()), "held_by_subsystem": ml.decompose(),
                   "conservation_ok": ml.conservation()["ok"]},
    }


# ---------------------------------------------------------------------------
# Launcher: wrap, gather, assemble.
# ---------------------------------------------------------------------------


def run_fleet(
    engine_factory: Callable[[str, int], Any],
    requests,
    *,
    prefill: int = 1,
    decode: int = 1,
    heartbeat_s: float = 0.05,
    lease_s: float = 0.5,
    admission_ttft_s: float = 0.0,
    fault_plan=None,
    flight: bool = True,
    job_timeout_s: float = 120.0,
) -> dict:
    """Launch the disaggregated fleet: 1 router + ``prefill`` +
    ``decode`` workers on the compat layer (the ``mpirun -n P`` shape),
    threads of this process.

    Args:
      engine_factory: ``(role, rank) -> Engine`` — called once per
        worker rank with role ``"prefill"`` or ``"decode"``. Workers
        need engines built from the SAME params/config for outputs to
        bit-match the single-engine run (prefill chunk width included:
        identical chunking → identical KV rows shipped).
      requests: iterable of :class:`~mpit_tpu_torch.serve.scheduler.Request`
        with unique rids.
      fault_plan: seeded :class:`~mpit_tpu_torch.compat.faults.FaultPlan` —
        ``kill_at={rank: step}`` kills a worker at its Nth unit of work
        (prefill: requests processed; decode: ticks run); the router's
        lease sweep re-queues its in-flight requests.
      flight: per-rank recorders + end-of-job gather — the result's
        ``flight`` block carries the skew report and the merged P2P
        matrix (KV shipment bytes ride it).

    Returns ``{"router": {...}, "workers": [...], "completed":
    {rid: tokens}, "shed": [...], "flight": {...}, "fault_events":
    (...)}``.
    """
    cfg = FleetConfig(
        prefill=prefill, decode=decode, heartbeat_s=heartbeat_s,
        lease_s=lease_s, admission_ttft_s=admission_ttft_s,
        job_timeout_s=job_timeout_s,
    )
    req_list = list(requests)

    def main(rank: int):
        rec_ctx = (
            _obs.local_recorder(_obs.Recorder()) if flight
            else contextlib.nullcontext()
        )
        with rec_ctx:
            ctl = mpiT.Comm_dup(None, key=CTL_CHANNEL)
            kv = mpiT.Comm_dup(None, key=SHIPMENT_CHANNEL)
            role = cfg.role_of(rank)
            if role == "router":
                out = _fleet_router(req_list, cfg, ctl)
            elif role == "prefill":
                out = _prefill_worker(
                    rank, engine_factory, cfg, fault_plan, ctl, kv,
                )
            else:
                out = _decode_worker(
                    rank, engine_factory, cfg, fault_plan, ctl, kv,
                )
            per_rank = (
                aggregate.gather_compat(root=ROUTER_RANK) if flight else None
            )
        if rank == ROUTER_RANK and per_rank is not None:
            out["_flight"] = {
                "skew": aggregate.skew_report(per_rank),
                "record": aggregate.flight_record(per_rank),
                "p2p_bytes": aggregate.merged_matrix(
                    per_rank, counter="p2p_send_bytes"
                ),
            }
        return out

    results = mpiT.run(
        main, cfg.nranks, pass_rank=True, timeout=job_timeout_s,
        fault_plan=fault_plan,
    )
    router = results[ROUTER_RANK]
    flight_doc = router.pop("_flight", None)
    out = {
        "router": router,
        "workers": results[1:],
        "completed": router["completed"],
        "shed": router["shed"],
    }
    if flight_doc is not None:
        out["flight"] = flight_doc
    if fault_plan is not None:
        out["fault_events"] = fault_plan.events()
    return out
