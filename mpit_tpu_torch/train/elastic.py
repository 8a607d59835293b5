"""The elastic asynchronous EASGD tier: the port of
:mod:`mpit_tpu.train.elastic`.

mpiT's defining capability — a pserver/pclient fleet that keeps training
through slow and dying workers (EASGD, arXiv:1412.6651): N replicas each
run :func:`~mpit_tpu_torch.train.loop.hardened_loop` and exchange an
elastic-averaging anchor

    replica:  x_i ← x_i − α·(x_i − x̃)
    anchor:   x̃  ← x̃ + α·(x_i − x̃)

with an anchor server on the port's compat simulator
(:mod:`mpit_tpu_torch.compat`, one thread a rank). The rules are JAX's:

- **Dedicated channel.** All anchor traffic rides ``Comm_dup(key=
  "elastic-anchor")``, its own matching space.
- **Bounded staleness.** Each replica exchanges every ``sync_every`` of
  its own steps; the server gauges how many centre versions a replica
  missed, and past ``staleness_bound`` notes it (an instant), never
  fatal.
- **Heartbeats and leases.** Each replica runs a heartbeat thread; the
  server's probe timeout is its liveness clock and it sweeps the leases
  between messages. A silent replica is evicted (out of the
  denominator: ``α = β / N_active`` when ``beta > 0``); one heard from
  again — by a heartbeat, an exchange or a rejoin — is readmitted.
- **Crash and rejoin.** A replica killed mid-run (``FaultPlan.kill_at``)
  stops its heartbeats, restores its latest
  :class:`~mpit_tpu_torch.train.checkpoint.AtomicCheckpoint`,
  re-registers (``TAG_REJOIN``), pulls the current centre and resumes
  for the remaining steps.
- **Quarantine.** Before every push the replica checks its parameters
  for finiteness; a diverged replica sends ``TAG_QUAR`` instead of its
  parameters, the loop's guard restores an older checkpoint, and the
  restore triggers a rejoin and a centre pull.

**On the card.** The centre lives on the run's device. An exchange
payload is ``[version_seen, *x]`` and a reply ``[version, alpha,
*centre]``, both f32 on the device, so each flat message is a send
snapshot and a delivery, each a launch of the KV copy kernel
(:func:`mpit_tpu_torch.ops.kv_ship.ship_bytes`): four launches an
exchange, two a register or rejoin. Control messages (``int32[1]``:
register, heartbeat, quarantine, rejoin, stop) stay on the CPU: compat
refuses a message that changes device. The version rides an f32 lane:
it is exact up to 2²⁴ exchanges. Rank threads share the device's default
stream, so the server enqueues the reply's snapshot of the centre before
the centre's update and a replica's packing and finiteness check read
its parameters after its own step.

A replica's training state is a
:class:`~mpit_tpu_torch.train.step.TrainState` whose ``params`` is its
flat f32 parameter vector (the :class:`~mpit_tpu_torch.opt.sharded.FlatLayout`
buffer its model's parameters are views of, as in the parity actors).
Its step updates that state in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings
from typing import Any, Callable, Iterator

import torch

from mpit_tpu_torch import compat as mpiT
from mpit_tpu_torch.compat.faults import FaultPlan, ReplicaKilled
from mpit_tpu_torch.obs import core as _obs
from mpit_tpu_torch.train.checkpoint import AtomicCheckpoint
from mpit_tpu_torch.train.loop import hardened_loop
from mpit_tpu_torch.train.metrics import MetricLogger

__all__ = [
    "ANCHOR_CHANNEL", "AnchorClient", "AnchorTimeoutError", "ElasticConfig", "SERVER_RANK",
    "anchor_server", "run_elastic",
]

ANCHOR_CHANNEL = "elastic-anchor"
SERVER_RANK = 0

# Anchor protocol tags (disjoint from the parity actors' 11..15).
TAG_REG = 31
TAG_HB = 32
TAG_EXCH = 33
TAG_CENTER = 34
TAG_QUAR = 35
TAG_REJOIN = 36
TAG_STOP = 37

_TAG_NAMES = {TAG_REG: "register", TAG_HB: "heartbeat", TAG_EXCH: "exchange",
              TAG_CENTER: "center", TAG_QUAR: "quarantine",
              TAG_REJOIN: "rejoin", TAG_STOP: "stop"}

@dataclasses.dataclass
class ElasticConfig:
    """Knobs of the elastic tier (the ``asyncsgd`` flags). ``alpha`` is
    the per-exchange coupling; with ``beta > 0`` the server uses ``beta /
    N_active`` instead. ``lease_s`` must comfortably exceed
    ``heartbeat_s`` (the server warns when it does not)."""

    replicas: int = 2
    steps: int = 60  # per-replica local steps
    sync_every: int = 4
    alpha: float = 0.125
    beta: float = 0.0
    staleness_bound: int = 8
    heartbeat_s: float = 0.05
    lease_s: float = 0.5
    exchange_timeout_s: float = 10.0
    exchange_retries: int = 3
    backoff: float = 1.5
    ckpt_dir: str = ""
    ckpt_every: int = 0
    max_restores: int = 2
    max_to_keep: int = 3
    log_every: int = 10
    fetch_lag: int = 2
    rejoin: bool = True  # a killed replica rejoins from its checkpoint


class AnchorTimeoutError(RuntimeError):
    """The anchor server stayed silent through every retry and backoff
    of one client call: the replica's view of a dead anchor."""


def _ctrl(step: int) -> torch.Tensor:
    return torch.tensor([step], dtype=torch.int32)


# ---------------------------------------------------------------------------
# Server actor.
# ---------------------------------------------------------------------------


class _ReplicaSlot:
    __slots__ = ("last_hb", "active", "quarantined", "stopped")

    def __init__(self, now: float):
        self.last_hb = now
        self.active = True
        self.quarantined = False
        self.stopped = False


@torch.no_grad()
def anchor_server(
    init_flat: torch.Tensor,
    cfg: ElasticConfig,
    *,
    nreplicas: int | None = None,
    comm=None,
    sentinel=None,
) -> dict:
    """The anchor actor: rank 0 of the elastic job.

    Serves register/exchange/rejoin/quarantine/stop on the anchor
    channel until every replica sent ``TAG_STOP``, sweeping the leases
    between messages (the probe timeout is the liveness clock).
    ``init_flat`` is the initial centre (copied, on its device). Returns
    the final ``center``, ``version``, ``alpha_final`` and the ``events``
    (``registered`` / ``evicted`` / ``rejoined`` / ``quarantined`` /
    ``staleness_exceeded`` / ``stopped`` tuples) with their counts.
    ``sentinel`` (a :class:`~mpit_tpu_torch.obs.Sentinel`) is noted each
    eviction and staleness breach, so they land in the run's anomaly
    report beside the step-time findings."""
    nreplicas = cfg.replicas if nreplicas is None else nreplicas
    if cfg.lease_s < 2 * cfg.heartbeat_s:
        warnings.warn(
            f"elastic: lease_s={cfg.lease_s} < 2x heartbeat_s="
            f"{cfg.heartbeat_s} — healthy replicas will flap eviction",
            stacklevel=2,
        )
    ship = mpiT.Comm_dup(comm, key=ANCHOR_CHANNEL)
    center = init_flat.detach().to(torch.float32).clone()
    device = center.device
    flat_buf = torch.empty(center.numel() + 1, dtype=torch.float32, device=device)
    ctrl_buf = torch.empty(1, dtype=torch.int32)
    version = 0
    slots: dict[int, _ReplicaSlot] = {}
    events: list[tuple] = []
    stops = 0
    probe_timeout = max(min(cfg.lease_s / 4.0, cfg.heartbeat_s), 0.005)

    def _active_count() -> int:
        return sum(1 for s in slots.values()
                   if s.active and not s.quarantined and not s.stopped)

    def _alpha() -> float:
        if cfg.beta > 0.0:
            return cfg.beta / max(1, _active_count())
        return cfg.alpha

    instant_names = {
        "evicted": "replica_evicted",
        "rejoined": "replica_rejoined",
        "quarantined": "replica_quarantined",
        "staleness_exceeded": "anchor_staleness_exceeded",
    }

    def _note(kind: str, rank: int, **extra):
        events.append((kind, rank, *extra.values()))
        _obs.instant(instant_names.get(kind, kind), rank=rank, **extra)
        if sentinel is not None and kind in ("evicted", "staleness_exceeded"):
            sentinel.note(kind, "anchor", version, rank=rank, **extra)

    def _gauges():
        _obs.gauge("active_replicas", _active_count())
        _obs.gauge("anchor_version", version)

    def _readmit(rank: int, how: str):
        s = slots[rank]
        if not s.active or s.quarantined:
            s.active = True
            s.quarantined = False
            _note("rejoined", rank, how=how)
            _gauges()

    def _sweep(now: float):
        for rank, s in slots.items():
            if s.stopped:
                continue
            age = now - s.last_hb
            _obs.gauge("replica_heartbeat_age_s", round(age, 4), rank=rank)
            if s.active and age > cfg.lease_s:
                s.active = False
                _note("evicted", rank, heartbeat_age_s=round(age, 4))
                _gauges()

    def _reply_center(rank: int):
        # [version, alpha, *center]: one payload, one Send (its snapshot
        # is enqueued before any later update of the centre); the client
        # applies the alpha the server uses, keeping the pull symmetric.
        head = torch.tensor([version, _alpha()], dtype=torch.float32, device=device)
        mpiT.Send(torch.cat([head, center]), dest=rank, tag=TAG_CENTER, comm=ship)

    while stops < nreplicas:
        try:
            with _obs.span("anchor:probe_wait"):
                st = mpiT.Probe(mpiT.ANY_SOURCE, mpiT.ANY_TAG, comm=ship,
                                timeout=probe_timeout)
        except mpiT.CompatTimeoutError:
            _sweep(time.monotonic())
            continue
        now = time.monotonic()
        _obs.counter("anchor_msgs", 1, kind=_TAG_NAMES.get(st.tag, str(st.tag)))
        if st.tag in (TAG_REG, TAG_REJOIN):
            mpiT.Recv(ctrl_buf, src=st.source, tag=st.tag, comm=ship)
            if st.source not in slots:
                slots[st.source] = _ReplicaSlot(now)
                events.append(("registered", st.source))
            else:
                slots[st.source].last_hb = now
                slots[st.source].stopped = False
                _readmit(st.source, how="rejoin")
            _gauges()
            _reply_center(st.source)
        elif st.tag == TAG_HB:
            mpiT.Recv(ctrl_buf, src=st.source, tag=TAG_HB, comm=ship)
            s = slots.get(st.source)
            if s is not None and not s.stopped:
                s.last_hb = now
                # A heartbeat from an evicted but live replica (a bounded
                # hang outlived its lease): readmit. A quarantined one
                # stays out until its explicit rejoin.
                if not s.active and not s.quarantined:
                    _readmit(st.source, how="heartbeat")
        elif st.tag == TAG_EXCH:
            mpiT.Recv(flat_buf, src=st.source, tag=TAG_EXCH, comm=ship)
            s = slots.get(st.source)
            if s is None:
                s = slots[st.source] = _ReplicaSlot(now)
                events.append(("registered", st.source))
            s.last_hb = now
            if not s.active and not s.quarantined:
                _readmit(st.source, how="exchange")
            staleness = version - int(flat_buf[0].item())
            _obs.gauge("replica_staleness", staleness, rank=st.source)
            if staleness > cfg.staleness_bound:
                _note("staleness_exceeded", st.source, staleness=staleness,
                      bound=cfg.staleness_bound)
            a = _alpha()
            _reply_center(st.source)
            with _obs.span("anchor:update"):
                center.add_((flat_buf[1:] - center).mul_(a))
            version += 1
            _gauges()
        elif st.tag == TAG_QUAR:
            mpiT.Recv(ctrl_buf, src=st.source, tag=TAG_QUAR, comm=ship)
            s = slots.get(st.source)
            if s is not None:
                s.quarantined = True
                s.last_hb = now
                _note("quarantined", st.source, step=int(ctrl_buf[0]))
                _gauges()
        elif st.tag == TAG_STOP:
            mpiT.Recv(ctrl_buf, src=st.source, tag=TAG_STOP, comm=ship)
            s = slots.get(st.source)
            if s is not None:
                s.stopped = True
            events.append(("stopped", st.source))
            stops += 1
            _gauges()
        else:  # consume it (no deadlock), then fail loudly (the pserver rule)
            mpiT.Recv(torch.empty(st.count, dtype=torch.float32, device=device),
                      src=st.source, tag=st.tag, comm=ship)
            raise RuntimeError(f"anchor_server: unexpected tag {st.tag} from {st.source}")
        _sweep(time.monotonic())
    return {
        "center": center,
        "version": version,
        "alpha_final": _alpha(),
        "events": events,
        "evictions": sum(1 for e in events if e[0] == "evicted"),
        "rejoins": sum(1 for e in events if e[0] == "rejoined"),
        "quarantines": sum(1 for e in events if e[0] == "quarantined"),
    }


# ---------------------------------------------------------------------------
# Client proxy (linked into each replica's training loop).
# ---------------------------------------------------------------------------


class AnchorClient:
    """A replica's anchor proxy: register / exchange / quarantine /
    rejoin / stop, and the heartbeat thread.

    Every round trip posts the reply's receive before it sends the
    request and waits with the compat ``timeout=`` under retry and
    backoff: a dead anchor is an :class:`AnchorTimeoutError` naming the
    call, never a silent hang. ``device`` is where the flat messages
    live (the replica's parameters')."""

    def __init__(self, flat_dim: int, cfg: ElasticConfig, *, device="cpu", comm=None):
        self._cfg = cfg
        self._ship = mpiT.Comm_dup(comm, key=ANCHOR_CHANNEL)
        self._rank = mpiT.Comm_rank(mpiT.COMM_WORLD)
        self._device = torch.device(device)
        self._buf = torch.empty(flat_dim + 2, dtype=torch.float32, device=self._device)
        self.version = 0
        self.alpha = cfg.alpha
        self._hb_stop: threading.Event | None = None
        self._hb_suspend_until = 0.0
        self._step = 0

    def _rpc(self, tag: int, payload: torch.Tensor, what: str) -> torch.Tensor:
        req = mpiT.Irecv(self._buf, src=SERVER_RANK, tag=TAG_CENTER, comm=self._ship)
        mpiT.Isend(payload, dest=SERVER_RANK, tag=tag, comm=self._ship)
        t = self._cfg.exchange_timeout_s
        for attempt in range(self._cfg.exchange_retries + 1):
            try:
                with _obs.span(f"anchor:{what}", attempt=attempt):
                    mpiT.Wait(req, timeout=t)
                break
            except mpiT.CompatTimeoutError:
                # The receive stays posted: retry the WAIT, never the send
                # (a duplicate TAG_EXCH would move the centre twice).
                _obs.counter("anchor_retries", 1, rank=self._rank)
                if attempt >= self._cfg.exchange_retries:
                    raise AnchorTimeoutError(
                        f"anchor {what} on rank {self._rank}: no reply "
                        f"after {attempt + 1} waits (last {t:.3g}s)"
                    ) from None
                t *= self._cfg.backoff
        version, alpha = self._buf[:2].tolist()
        self.version, self.alpha = int(version), float(alpha)
        return self._buf[2:]

    def register(self, step: int = 0) -> torch.Tensor:
        self._step = step
        return self._rpc(TAG_REG, _ctrl(step), "register").clone()

    def rejoin(self, step: int) -> torch.Tensor:
        """Re-register after a crash or quarantine restore and pull the
        current centre (apply the elastic pull to the restored
        parameters before training on)."""
        self._step = step
        return self._rpc(TAG_REJOIN, _ctrl(step), "rejoin").clone()

    @torch.no_grad()
    def exchange(self, flat: torch.Tensor, step: int) -> torch.Tensor:
        """One EASGD round trip: push ``x_i`` stamped with the last centre
        version this replica saw (the server's staleness input), pull the
        centre, return the pulled parameters ``x − α·(x − x̃)`` (new)."""
        self._step = step
        head = torch.tensor([float(self.version)], dtype=torch.float32, device=flat.device)
        center = self._rpc(TAG_EXCH, torch.cat([head, flat.to(torch.float32)]), "exchange")
        return flat - (flat - center).mul_(self.alpha)

    def quarantine(self, step: int) -> None:
        """Tell the anchor this replica's parameters are poisoned: it
        leaves the denominator and nothing is pushed."""
        mpiT.Isend(_ctrl(step), dest=SERVER_RANK, tag=TAG_QUAR, comm=self._ship)

    def stop(self, step: int) -> None:
        self.stop_heartbeats()
        mpiT.Isend(_ctrl(step), dest=SERVER_RANK, tag=TAG_STOP, comm=self._ship)

    def start_heartbeats(self) -> None:
        if self._hb_stop is not None:
            return
        stop = self._hb_stop = threading.Event()
        rank, ship, cfg = self._rank, self._ship, self._cfg
        # The replica thread's recorder: heartbeat sends are charged to
        # this rank's events, so the flight record's send matrix agrees
        # with the server's receive counts.
        rank_rec = _obs.get_recorder()

        def _beat():
            mpiT.bind_thread(rank, ship)
            rec_ctx = (_obs.local_recorder(rank_rec) if rank_rec is not None
                       else contextlib.nullcontext())
            with rec_ctx:
                while not stop.wait(cfg.heartbeat_s):
                    if time.monotonic() < self._hb_suspend_until:
                        continue  # a simulated full-process stall
                    mpiT.Send(_ctrl(self._step), dest=SERVER_RANK, tag=TAG_HB, comm=ship)

        threading.Thread(target=_beat, daemon=True, name=f"elastic-hb-{rank}").start()

    def suspend_heartbeats(self, seconds: float) -> None:
        """Model a full-process stall (``FaultPlan.hang_at``): compute and
        heartbeats stop, so the lease can expire."""
        self._hb_suspend_until = time.monotonic() + seconds

    def stop_heartbeats(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None


# ---------------------------------------------------------------------------
# Replica runner: hardened_loop + anchor exchange + fault application.
# ---------------------------------------------------------------------------


class _RestoreHookLogger:
    """The logger seam: calls ``hook(step)`` on the loop's
    ``restored_after_divergence`` event (the loop owns the restore; the
    tier only needs to know it happened), and collects every logged
    loss, so a crashed loop's segment is not lost with its result."""

    def __init__(self, inner: MetricLogger, hook: Callable[[int], None]):
        self._inner = inner
        self._hook = hook
        self.losses: list[float] = []

    def log(self, step: int, metrics: dict) -> None:
        if metrics.get("event") == "restored_after_divergence":
            self._hook(int(step))
        loss = metrics.get("loss")
        if isinstance(loss, (int, float)):
            self.losses.append(float(loss))
        self._inner.log(step, metrics)


def _replica_body(
    rank: int,
    ridx: int,
    cfg: ElasticConfig,
    init_replica: Callable[[], tuple[Any, Callable]],
    stream_factory: Callable[[int, int], Iterator],
    plan: FaultPlan | None,
    items_per_batch: int | None,
    verbose: bool,
) -> dict:
    state, step_fn = init_replica()
    flat = state.params
    client = AnchorClient(flat.numel(), cfg, device=flat.device)
    client.register(0)
    client.start_heartbeats()
    ckpt = (AtomicCheckpoint(os.path.join(cfg.ckpt_dir, f"replica{ridx}"),
                             max_to_keep=cfg.max_to_keep) if cfg.ckpt_dir else None)
    stats = {"replica": ridx, "restores": 0, "rejoins": 0, "quarantines": 0,
             "crashes": 0, "exchanges": 0}
    cell: dict[str, Any] = {"quarantined": False, "pending_center": None}

    def _on_restore(restored_step: int) -> None:
        # The loop restored this replica after a divergence: rejoin and
        # stage the centre pull for the next wrapped call.
        stats["restores"] += 1
        center = client.rejoin(restored_step)
        cell["pending_center"] = (center, client.alpha)
        cell["quarantined"] = False
        stats["rejoins"] += 1

    @torch.no_grad()
    def pull(center, alpha):
        flat.sub_((flat - center).mul_(alpha))

    def wrapped(state, batch):
        k = state.step
        pc = cell.pop("pending_center", None)
        if pc is not None:
            pull(*pc)
        if plan is not None:
            act = plan.step_action(rank, k)  # may raise ReplicaKilled
            if act.hang_s:
                # A full-process stall: heartbeats stop too, the lease
                # expires, the resumed heartbeat readmits.
                client.suspend_heartbeats(act.hang_s)
                time.sleep(act.hang_s)
            elif act.sleep_s:
                time.sleep(act.sleep_s)
        state, metrics = step_fn(state, batch)
        if plan is not None and act.nan:
            # Poison the step's parameters: the next loss is non-finite
            # and the check below keeps the poison out of the anchor.
            with torch.no_grad():
                flat.mul_(float("nan"))
        k += 1
        client._step = k
        if k % cfg.sync_every == 0:
            if not bool(torch.isfinite(flat).all()):
                # Quarantine: a diverged replica never pushes.
                if not cell["quarantined"]:
                    cell["quarantined"] = True
                    stats["quarantines"] += 1
                    client.quarantine(k)
                    _obs.instant("replica_diverged_local", rank=rank, step=k)
            elif not cell["quarantined"]:
                with _obs.span("elastic_exchange", step=k):
                    pulled = client.exchange(flat, k)
                stats["exchanges"] += 1
                with torch.no_grad():
                    flat.copy_(pulled)
        return state, metrics

    logger = _RestoreHookLogger(MetricLogger(stdout=verbose), _on_restore)
    result = None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        # A relaunched fleet resumes each replica from its latest
        # checkpoint; the centre is soft state, rebuilt by the exchanges.
        ckpt.restore(state)
        start_step = state.step
        stats["resumed_from"] = start_step
    t0 = time.perf_counter()
    try:
        while True:
            try:
                result = hardened_loop(
                    state, wrapped, stream_factory(ridx, start_step),
                    steps=cfg.steps, device=flat.device, items_per_batch=items_per_batch,
                    log_every=cfg.log_every, logger=logger, ckpt=ckpt,
                    ckpt_every=cfg.ckpt_every if ckpt else 0,
                    max_restores=cfg.max_restores, fetch_lag=cfg.fetch_lag,
                )
                break
            except ReplicaKilled as rk:
                # The crash: the heart stops, the anchor evicts on lease
                # expiry. Rejoin: restore the latest checkpoint,
                # re-register, pull the centre, train the remaining steps.
                stats["crashes"] += 1
                client.stop_heartbeats()
                _obs.instant("replica_crashed", rank=rank, step=rk.step)
                if not cfg.rejoin or ckpt is None or ckpt.latest_step() is None:
                    stats["dead_at"] = rk.step
                    break
                if plan is not None and plan.rejoin_delay_s > 0:
                    time.sleep(plan.rejoin_delay_s)
                ckpt.restore(state)
                start_step = state.step
                stats["rejoin_steps_to_recover"] = rk.step - start_step
                center = client.rejoin(start_step)
                cell["pending_center"] = (center, client.alpha)
                cell["quarantined"] = False
                stats["rejoins"] += 1
                client.start_heartbeats()
    finally:
        client.stop(state.step)
    wall = time.perf_counter() - t0
    steps_done = int(result["steps"]) if result else state.step
    losses = logger.losses
    out = {
        **stats,
        "steps": steps_done,
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "wall_s": round(wall, 3),
        "steps_per_s": round(steps_done / wall, 3) if wall > 0 else 0.0,
        "completed": result is not None,
    }
    if result:
        out["loop_restores"] = result["restores"]
        for key in ("items_per_sec", "items_per_sec_last", "items_per_sec_mean"):
            if key in result:
                out[key] = result[key]
    return out


# ---------------------------------------------------------------------------
# Fleet launcher.
# ---------------------------------------------------------------------------


def run_elastic(
    cfg: ElasticConfig,
    init_replica: Callable[[], tuple[Any, Callable]],
    stream_factory: Callable[[int, int], Iterator],
    *,
    fault_plan: FaultPlan | None = None,
    sentinel=None,
    items_per_batch: int | None = None,
    job_timeout_s: float = 600.0,
    flight: bool = True,
    verbose: bool = False,
) -> dict:
    """Launch the elastic fleet: 1 anchor server and ``cfg.replicas``
    replicas on the compat simulator (the ``mpirun -n P`` shape).

    ``init_replica() -> (state, step_fn)`` is called once by the server
    (its ``state.params`` seeds the centre) and once by every replica:
    a fresh :class:`~mpit_tpu_torch.train.step.TrainState` whose
    ``params`` is the flat f32 vector on the run's device (every replica
    from the same initial values) and the step that updates it in place,
    ``step_fn(state, batch) -> (state, {"loss": ...})``.
    ``stream_factory(replica_idx, skip)`` gives a replica's batches past
    ``skip`` steps (the rejoin's resume). ``fault_plan``: seeded message
    faults on the job's wire and step faults in the replica wrapper.
    ``flight``: a recorder per rank, gathered to the server at the end
    (the result's ``flight``: the skew report, the flight record and
    ``step_straggler_rank``). ``sentinel``: the anchor server notes its
    evictions and staleness breaches into it (the result's ``sentinel``
    is its report). ``job_timeout_s``: the compat job's wall-clock limit.

    Returns ``{"server", "replicas", "center", "version", "flight",
    "fault_events"[, "sentinel"]}``."""
    from mpit_tpu_torch.obs import aggregate

    state0, _ = init_replica()
    init_flat = state0.params.detach().clone()
    del state0

    def main(rank: int):
        rec_ctx = (_obs.local_recorder(_obs.Recorder()) if flight
                   else contextlib.nullcontext())
        with rec_ctx:
            if rank == SERVER_RANK:
                out = anchor_server(init_flat, cfg, sentinel=sentinel)
            else:
                out = _replica_body(rank, rank - 1, cfg, init_replica, stream_factory,
                                    fault_plan, items_per_batch, verbose)
            per_rank = aggregate.gather_compat(root=SERVER_RANK) if flight else None
        if rank == SERVER_RANK and per_rank is not None:
            out["_flight"] = {
                "skew": aggregate.skew_report(per_rank),
                "record": aggregate.flight_record(per_rank),
            }
        return out

    results = mpiT.run(main, cfg.replicas + 1, pass_rank=True, timeout=job_timeout_s,
                       fault_plan=fault_plan)
    server = results[SERVER_RANK]
    flight_doc = server.pop("_flight", None)
    out = {
        "server": server,
        "replicas": results[1:],
        "center": server["center"],
        "version": server["version"],
    }
    if flight_doc is not None:
        # "Which replica straggled?" reads the training step phase (the
        # record's largest skew is usually the server's probe wait).
        step_skew = flight_doc["skew"].get("step")
        if step_skew is not None:
            flight_doc["step_straggler_rank"] = step_skew["max_rank"]
        out["flight"] = flight_doc
    if fault_plan is not None:
        out["fault_events"] = fault_plan.events()
    if sentinel is not None:
        out["sentinel"] = sentinel.report()
    return out
