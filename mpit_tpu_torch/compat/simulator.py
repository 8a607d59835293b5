"""Host-level multi-rank MPI simulator backing the ``mpiT`` facade: the
port of :mod:`mpit_tpu.compat.simulator`.

Reference semantics reproduced here (SURVEY.md §3.1 C1, §4.2): tagged
point-to-point with ``ANY_SOURCE``/``ANY_TAG`` wildcards, MPI's
posted-receive matching order and non-overtaking rule; nonblocking
``Isend``/``Irecv`` returning request objects polled via ``Wait``/``Test``;
rendezvous collectives. Each MPI *process* becomes a Python *thread*;
libmpi's transport becomes a condition-variable mailbox. It exists so
that reference-shaped programs (rank-role scripts, the parameter-server
actors, the serving fleet) run with their original semantics.

Buffers are torch tensors, on the CPU or on the card. Numpy arrays are
taken through ``torch.from_numpy``, which shares their memory, so a
receive into a numpy buffer lands in it and scripted numpy programs run
unchanged; any other array-like goes through ``np.asarray`` first.
``Recv``-style calls write into the caller's buffer *and* return it.

The simulator copies payload bytes at exactly two points: a buffered
``Send`` snapshots the sender's buffer, and delivery writes the message
into the receiver's buffer (collectives snapshot their deposits the same
way). Both go through :func:`mpit_tpu_torch.ops.kv_ship.ship_bytes`: the
CUDA copy kernel for tensors on the card, ``copy_`` for CPU tensors. A
message never changes device: a CUDA message into a CPU buffer (or the
reverse) raises ``TypeError``, like a dtype mismatch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from mpit_tpu_torch.obs import core as _obs
from mpit_tpu_torch.ops.kv_ship import ship_bytes, tensor_nbytes

# ---------------------------------------------------------------------------
# Constants — the mpiT.* constant surface (SURVEY.md §3.1 C1).
# ---------------------------------------------------------------------------

ANY_SOURCE = -1
ANY_TAG = -1

# Datatype constants. The C binding needed these to pick MPI_Datatype for a
# raw pointer; here buffers carry their own dtype, so these exist only so
# reference-shaped call sites (`mpiT.FLOAT` etc.) keep reading naturally.
# Receives enforce sender/receiver dtype agreement instead (_check_transfer).
DOUBLE = torch.float64
FLOAT = torch.float32
INT = torch.int32
LONG = torch.int64
CHAR = torch.uint8
BYTE = torch.uint8

# Reduce ops.
SUM = "sum"
MAX = "max"
MIN = "min"
PROD = "prod"

_REDUCERS: dict[str, Callable[[list[torch.Tensor]], torch.Tensor]] = {
    SUM: lambda xs: torch.stack(xs).sum(0),
    MAX: lambda xs: torch.stack(xs).amax(0),
    MIN: lambda xs: torch.stack(xs).amin(0),
    PROD: lambda xs: torch.stack(xs).prod(0),
}


@dataclasses.dataclass
class Status:
    """The ``MPI_Status`` analogue: who sent the matched message, and what."""

    source: int
    tag: int
    count: int


def _as_tensor(buf) -> torch.Tensor:
    """A buffer as a tensor: tensors as they are, numpy arrays through
    ``torch.from_numpy`` (sharing their memory), anything else through
    ``np.asarray`` first."""
    if isinstance(buf, torch.Tensor):
        return buf
    arr = np.asarray(buf)
    if not arr.flags.writeable:
        arr = arr.copy()  # a read-only array can only be sent
    return torch.from_numpy(arr)


def _copy_of(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on its own device: the send snapshot."""
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    if t.is_contiguous():
        return ship_bytes(t, out)
    if t.device.type != "cpu":
        raise ValueError("a CUDA send buffer must be contiguous")
    return out.copy_(t)


def _deliver(buf: torch.Tensor, data: torch.Tensor) -> None:
    """Write a checked message into the receiver's buffer."""
    if buf.is_contiguous():
        ship_bytes(data, buf)
    elif buf.device.type == "cpu":
        buf.copy_(data.reshape(buf.shape))
    else:
        raise ValueError("a CUDA receive buffer must be contiguous")


def _check_transfer(buf: torch.Tensor, data: torch.Tensor) -> None:
    """Receive-side contract: size, dtype and device type must match
    exactly.

    MPI would interpret raw bytes through the declared MPI_Datatype;
    silently casting (e.g. float64 payload into an int32 buffer) would hide
    porting bugs, so mismatches raise instead. A message on the card never
    moves to a CPU buffer behind the caller's back (nor the reverse).
    """
    if data.numel() != buf.numel():
        raise ValueError(f"recv buffer size {buf.numel()} != message size {data.numel()}")
    if data.dtype != buf.dtype:
        raise TypeError(
            f"recv buffer dtype {buf.dtype} != message dtype {data.dtype}"
        )
    if data.device.type != buf.device.type:
        raise TypeError(
            f"recv buffer device {buf.device} != message device {data.device}"
        )


class _Message:
    __slots__ = ("src", "tag", "data")

    def __init__(self, src: int, tag: int, data: torch.Tensor):
        self.src = src
        self.tag = tag
        self.data = data


def _matches(msg: _Message, src: int, tag: int) -> bool:
    """The MPI envelope-matching rule, wildcards included."""
    return (src == ANY_SOURCE or msg.src == src) and (
        tag == ANY_TAG or msg.tag == tag
    )


class AbortedError(RuntimeError):
    """Raised on ranks parked in Recv/Wait/Test/Probe when the job aborts
    (another rank died) — the analogue of mpirun killing the job."""


class CompatTimeoutError(TimeoutError):
    """A blocking compat call (``Recv``/``Wait``/``Probe``) exceeded its
    ``timeout=`` — the structured alternative to blocking forever on a
    dead or wedged peer. Carries the waiting rank,
    the operation, and the ``(src, tag)`` envelope it was matching, so a
    tier-1 hang becomes a diagnosable assertion instead of a stuck
    process. ``ANY_SOURCE``/``ANY_TAG`` render as ``"any"``."""

    def __init__(self, *, op: str, rank: int, src: int, tag: int, timeout: float):
        def _w(v: int) -> str:
            return "any" if v in (ANY_SOURCE, ANY_TAG) else str(v)

        super().__init__(
            f"{op} on rank {rank} timed out after {timeout}s waiting for "
            f"src={_w(src)} tag={_w(tag)} (peer dead, message dropped, or "
            "deadlock)"
        )
        self.op = op
        self.rank = rank
        self.src = src
        self.tag = tag
        self.timeout = timeout


class Request:
    """The ``MPI_Request`` analogue returned by ``Isend``/``Irecv``.

    Isend requests complete immediately (buffered-send semantics — the
    simulator's mailbox *is* the buffer, matching MPI's eager protocol for
    the small messages the reference sends). Irecv requests are *posted* to
    the destination mailbox at call time — matching happens in post order as
    messages arrive (MPI's posted-receive queue), not at Wait/Test time.
    """

    def __init__(
        self,
        comm: "Comm",
        kind: str,
        buf: torch.Tensor | None = None,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        rank: int | None = None,
    ):
        self._comm = comm
        self._kind = kind
        self._buf = buf
        self._src = src
        self._tag = tag
        self._rank = rank
        self._done = kind == "send"
        self.status: Status | None = None
        # Receive-side obs attribution: capture the POSTING
        # thread's recorder now — delivery may run on the *sender's*
        # thread via put(), and under per-rank thread-local recorders
        # (obs.local_recorder) the bytes must land in the RECEIVER's
        # stream, or the merged flight-recorder matrix mis-attributes
        # every eagerly-delivered message to its sender's rank.
        self._obs_rec = _obs.get_recorder() if kind == "recv" else None

    def _complete_locked(self, msg: _Message) -> None:
        """Deliver ``msg`` into this request's buffer. Caller holds the
        mailbox lock (may run on the *sender's* thread via ``put``)."""
        assert self._buf is not None
        data = msg.data
        _check_transfer(self._buf, data)
        _deliver(self._buf, data)
        self.status = Status(source=msg.src, tag=msg.tag, count=data.numel())
        self._done = True
        # Counts at DELIVERY (the matching moment) into the receiver's
        # recorder captured at post time — the obs lock never nests
        # inside the mailbox lock the other way. A delivery that lands
        # after the recorder was drained (a recv outstanding across a
        # flight-recorder gather) credits the SAME still-installed
        # object and ships with the next interval — interval
        # accounting, not loss. Fallback: a recv posted before
        # obs.enable() still counts against the GLOBAL recorder live at
        # delivery (never the delivering thread's thread-local one,
        # which may belong to the SENDER's rank).
        rec = self._obs_rec
        if rec is None:
            rec = _obs.get_global_recorder()
        if rec is not None:
            attrs = {"src": msg.src, "dst": self._rank}
            rec.add_counter("p2p_recv_bytes", tensor_nbytes(data), attrs)
            rec.add_counter("p2p_recv_msgs", 1, attrs)

    def wait(self, timeout: float | None = None) -> Status | None:
        """Block until complete — ``mpiT.Wait`` analogue. With
        ``timeout`` (seconds), raise :class:`CompatTimeoutError` instead
        of blocking forever; the request stays posted and a later
        ``wait``/``test`` can still complete it (retry-with-backoff is
        built on exactly that)."""
        if not self._done:
            assert self._rank is not None
            if not self._comm._boxes[self._rank].wait_request(self, timeout):
                raise CompatTimeoutError(
                    op="Wait", rank=self._rank, src=self._src,
                    tag=self._tag, timeout=timeout,
                )
        return self.status

    def test(self) -> bool:
        """Nonblocking completion poll — ``mpiT.Test`` analogue."""
        if self._done:
            return True
        assert self._rank is not None
        return self._comm._boxes[self._rank].test_request(self)


class _Mailbox:
    """Per-rank transport state (the libmpi analogue): an unexpected-message
    queue plus a posted-receive queue, both matched in arrival/post order —
    which preserves MPI's non-overtaking rule per (src, tag) and its
    posted-receive matching semantics (a message is routed to the *earliest
    posted* matching receive at the moment it arrives, regardless of the
    order Wait/Test are later called in).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_Message] = []   # arrived, unmatched
        self._posted: list[Request] = []     # posted Irecvs, unmatched
        self._aborted = False

    def _check_abort(self) -> None:
        if self._aborted:
            raise AbortedError("job aborted (a peer rank died)")

    def put(self, msg: _Message) -> None:
        """Deliver a message: earliest matching posted receive wins, else
        queue as unexpected. May complete a request on the sender's thread."""
        with self._cond:
            for i, req in enumerate(self._posted):
                if _matches(msg, req._src, req._tag):
                    self._posted.pop(i)
                    req._complete_locked(msg)
                    self._cond.notify_all()
                    return
            self._pending.append(msg)
            self._cond.notify_all()

    def post(self, req: Request) -> None:
        """Post a receive: match the earliest pending message now, else
        queue on the posted-receive list."""
        with self._cond:
            self._check_abort()
            for i, m in enumerate(self._pending):
                if _matches(m, req._src, req._tag):
                    self._pending.pop(i)
                    req._complete_locked(m)
                    return
            self._posted.append(req)

    def wait_request(self, req: Request, timeout: float | None = None) -> bool:
        """Block until ``req`` completes; ``False`` on timeout (the
        request stays posted — the caller may retry or give up)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            while not req._done:
                self._check_abort()
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(remaining)
        return True

    def test_request(self, req: Request) -> bool:
        with self._cond:
            if not req._done:
                self._check_abort()
            return req._done

    def peek(
        self,
        src: int,
        tag: int,
        *,
        block: bool = True,
        timeout: float | None = None,
    ) -> _Message | None:
        """Probe: wait for (or poll) a matching unexpected message without
        consuming it. ``timeout`` bounds the blocking wait (``None`` on
        expiry — the caller raises the structured error with its own
        envelope context)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            while True:
                self._check_abort()
                for m in self._pending:
                    if _matches(m, src, tag):
                        return m
                if not block:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    def describe(self) -> dict:
        """Diagnostic snapshot for the deadlock watchdog: what this rank
        is holding (unmatched arrived messages) and waiting for (posted
        receives) — the state a hung job's dump needs to name the cycle."""
        with self._cond:
            return {
                "pending": [
                    {"src": m.src, "tag": m.tag, "count": m.data.numel()}
                    for m in self._pending
                ],
                "posted": [
                    {"src": r._src, "tag": r._tag} for r in self._posted
                ],
                "aborted": self._aborted,
            }

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


class Comm:
    """A communicator: a fixed group of ranks — the ``MPI_Comm`` analogue.

    Holds the mailboxes (P2P transport) and a two-phase rendezvous used by
    all collectives. ``COMM_WORLD`` is resolved per-run to the communicator
    created by :func:`run`.
    """

    def __init__(self, size: int, name: str = "world"):
        self.size = size
        self.name = name
        self._boxes = [_Mailbox() for _ in range(size)]
        self._barrier = threading.Barrier(size)
        self._slots: list[Any] = [None] * size
        self._dup_lock = threading.Lock()
        self._dups: dict[str, "Comm"] = {}
        self._aborted = False
        # Installed fault plan (compat.faults.FaultPlan) — consulted by
        # Send; dups inherit it so library channels see the same wire.
        self._fault_plan = None

    def describe(self) -> dict:
        """Per-rank mailbox state of this communicator AND its dups —
        the deadlock watchdog's dump: when a job
        times out, this names who is parked on what instead of leaving
        a silent hang."""
        with self._dup_lock:
            dups = dict(self._dups)
        out = {
            "comm": self.name,
            "ranks": {r: box.describe() for r, box in enumerate(self._boxes)},
        }
        if dups:
            out["dups"] = {k: d.describe() for k, d in sorted(dups.items())}
        return out

    # -- collective rendezvous ------------------------------------------------
    def abort(self) -> None:
        """Abort the job: break the barrier and wake all blocked
        receivers — on this communicator AND its dups (a rank parked in
        Recv on a duplicated communicator must die with the job too).
        The flag makes the abort durable: a dup created AFTER the abort
        (a survivor rank entering a gather while a peer is already
        dead) is born aborted instead of parking its creator forever."""
        with self._dup_lock:
            self._aborted = True
            dups = list(self._dups.values())
        self._barrier.abort()
        for box in self._boxes:
            box.abort()
        for d in dups:
            d.abort()

    def _exchange(self, rank: int, value: Any) -> list[Any]:
        """Deposit ``value``, wait for all ranks, return everyone's deposits.

        Deposits are **copied**: a rank may mutate its buffer the moment its
        own collective call returns, while slower peers are still reading —
        MPI's "buffer is yours again after return" contract requires the
        snapshot. Two barrier phases: after the first, all deposits are
        visible; the second guards the slots against being overwritten by a
        subsequent collective before every rank has read them.
        """
        self._slots[rank] = (
            _copy_of(value) if isinstance(value, torch.Tensor) else value
        )
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out


# ---------------------------------------------------------------------------
# Per-thread rank context (what `mpirun` + MPI_Init gave each process).
# ---------------------------------------------------------------------------

_ctx = threading.local()


def _require_ctx() -> tuple[int, Comm]:
    rank = getattr(_ctx, "rank", None)
    comm = getattr(_ctx, "comm", None)
    if rank is None or comm is None:
        # A bare script run outside `run()` is a world of one — exactly what
        # running a reference script without mpirun gives.
        comm = Comm(1, name="self")
        _ctx.rank = rank = 0
        _ctx.comm = comm
        _ctx.initialized = False
    return rank, comm


def _resolve(comm: Comm | None) -> Comm:
    if comm is None or comm is COMM_WORLD:
        return _require_ctx()[1]
    return comm


class _WorldSentinel:
    """``mpiT.COMM_WORLD``: resolves to the current run's world communicator."""

    def __repr__(self) -> str:  # pragma: no cover
        return "COMM_WORLD"


COMM_WORLD = _WorldSentinel()


# ---------------------------------------------------------------------------
# The mpiT API surface.
# ---------------------------------------------------------------------------


def Init() -> None:
    """``mpiT.Init()``: join the world set up by the launcher."""
    _require_ctx()
    _ctx.initialized = True


def Initialized() -> bool:
    return bool(getattr(_ctx, "initialized", False))


def Finalize() -> None:
    """``mpiT.Finalize()``: leave the world (drains nothing; the simulator's
    mailboxes die with the run)."""
    _ctx.initialized = False


def Comm_rank(comm: Comm | None = None) -> int:
    """``mpiT.Comm_rank``."""
    rank, c = _require_ctx()
    if comm is None or comm is COMM_WORLD or c is comm:
        return rank
    raise ValueError("simulator supports rank queries on the world communicator")


def Comm_size(comm: Comm | None = None) -> int:
    """``mpiT.Comm_size``."""
    return _resolve(comm).size


def Get_processor_name() -> str:
    import platform

    return platform.node() or "localhost"


def Comm_dup(comm: Comm | None = None, *, key: str = "dup") -> Comm:
    """``MPI_Comm_dup`` analogue: a communicator with the same group but
    a SEPARATE matching space (own mailboxes, own barrier).

    The MPI reason to dup is exactly why this exists here: library
    traffic (e.g. the flight recorder's snapshot shipments,
    ``obs.aggregate.gather_compat``) must be un-stealable by the
    application's outstanding wildcard receives — an ``ANY_TAG`` Irecv
    posted on the parent can never match a message sent on the dup.
    Lazily created once per ``(comm, key)`` and shared by all ranks
    (the parent Comm object is the shared rendezvous point); aborting
    the parent aborts its dups.
    """
    c = _resolve(comm)
    with c._dup_lock:
        d = c._dups.get(key)
        if d is None:
            d = c._dups[key] = Comm(c.size, name=f"{c.name}.{key}")
            d._fault_plan = c._fault_plan  # same wire, same faults
            if c._aborted:
                # Parent died before this dup existed: the dup is born
                # aborted, so a survivor blocking on it gets the
                # AbortedError instead of a deadlock.
                d.abort()
    return d


# -- point-to-point ----------------------------------------------------------


def Send(buf, dest: int, tag: int = 0, comm: Comm | None = None) -> None:
    """Blocking tagged send — ``mpiT.Send``. Buffered: the message is a
    snapshot of ``buf`` on its own device, so the caller may reuse
    ``buf`` at once."""
    rank, _ = _require_ctx()
    c = _resolve(comm)
    data = _copy_of(_as_tensor(buf))
    if _obs.enabled():
        # Send-side traffic accounting: the rank×rank byte matrix of the
        # flight recorder (obs.aggregate.merged_matrix) reads these.
        _obs.counter("p2p_send_bytes", tensor_nbytes(data), src=rank, dst=dest)
        _obs.counter("p2p_send_msgs", 1, src=rank, dst=dest)
    msg = _Message(rank, tag, data)
    plan = c._fault_plan
    if plan is not None:
        # Fault injection (compat/faults.py): the installed
        # plan may drop this message or deliver it late. Decisions are
        # logged on the plan; send-side obs counters above already ran —
        # the wire ATTEMPT is what send accounting means, and a matrix
        # reconciliation under faults is expected to disagree by exactly
        # the dropped bytes.
        fault = plan.message_fault(rank, dest, tag)
        if fault is not None:
            kind, delay_s = fault
            if kind == "drop":
                if _obs.enabled():
                    _obs.instant(
                        "message_dropped", src=rank, dst=dest, tag=tag
                    )
                return
            box = c._boxes[dest]
            t = threading.Timer(delay_s, box.put, args=(msg,))
            t.daemon = True
            t.start()
            return
    c._boxes[dest].put(msg)


def Recv(
    buf,
    src: int = ANY_SOURCE,
    tag: int = ANY_TAG,
    comm: Comm | None = None,
    *,
    timeout: float | None = None,
) -> Status:
    """Blocking tagged receive into ``buf`` — ``mpiT.Recv``. Returns Status
    (where the reference surfaced source/tag via MPI_Status for the
    ANY_SOURCE server loop, SURVEY.md §4.2).

    Implemented as post-then-wait, so it takes its place in the
    posted-receive queue *after* any outstanding Irecvs — MPI's matching
    order. ``timeout`` (seconds) converts a would-be
    forever-block on a dead peer into a structured
    :class:`CompatTimeoutError` naming the rank and the ``(src, tag)``
    envelope; on timeout the posted receive is WITHDRAWN (a message
    arriving later goes to the unexpected queue, not into a buffer the
    caller has moved on from).
    """
    req = Irecv(buf, src, tag, comm)
    try:
        st = req.wait(timeout)
    except CompatTimeoutError:
        # Withdraw the posted receive under the mailbox lock; the race
        # where the message lands between the timeout and the withdrawal
        # resolves to successful delivery (checked below).
        rank, _ = _require_ctx()
        c = _resolve(comm)
        box = c._boxes[rank]
        with box._cond:
            if not req._done:
                try:
                    box._posted.remove(req)
                except ValueError:
                    pass
                raise CompatTimeoutError(
                    op="Recv", rank=rank, src=src, tag=tag, timeout=timeout
                ) from None
        st = req.status
    assert st is not None
    return st


def Isend(buf, dest: int, tag: int = 0, comm: Comm | None = None) -> Request:
    """Nonblocking send — ``mpiT.Isend``. Completes immediately (buffered)."""
    Send(buf, dest, tag, comm)
    return Request(_resolve(comm), "send")


def Irecv(
    buf,
    src: int = ANY_SOURCE,
    tag: int = ANY_TAG,
    comm: Comm | None = None,
) -> Request:
    """Nonblocking receive — ``mpiT.Irecv``; complete via Wait/Test.

    The receive is *posted* now: an arriving message is routed to the
    earliest posted matching receive, independent of Wait/Test order.
    """
    rank, _ = _require_ctx()
    c = _resolve(comm)
    req = Request(c, "recv", buf=_as_tensor(buf), src=src, tag=tag, rank=rank)
    c._boxes[rank].post(req)
    return req


def Wait(req: Request, *, timeout: float | None = None) -> Status | None:
    """``mpiT.Wait``. With ``timeout`` raises
    :class:`CompatTimeoutError` instead of blocking forever (the request
    stays posted — retry by calling ``Wait`` again)."""
    return req.wait(timeout)


def Waitall(reqs: Sequence[Request]) -> list[Status | None]:
    return [r.wait() for r in reqs]


def Test(req: Request) -> bool:
    """``mpiT.Test``."""
    return req.test()


def Probe(
    src: int = ANY_SOURCE,
    tag: int = ANY_TAG,
    comm: Comm | None = None,
    *,
    timeout: float | None = None,
) -> Status:
    """Blocking probe — ``mpiT.Probe``: Status of the next matching message
    without consuming it (the server loop's peek-then-dispatch tool).
    ``timeout`` raises :class:`CompatTimeoutError` on expiry — the
    anchor server's lease sweep runs off exactly this (probe with a
    bounded wait, service liveness on the timeout path)."""
    rank, _ = _require_ctx()
    c = _resolve(comm)
    msg = c._boxes[rank].peek(src, tag, block=True, timeout=timeout)
    if msg is None:
        raise CompatTimeoutError(
            op="Probe", rank=rank, src=src, tag=tag, timeout=timeout
        )
    return Status(source=msg.src, tag=msg.tag, count=msg.data.numel())


def bind_thread(rank: int, comm: Comm) -> None:
    """Adopt ``rank``'s identity on the CALLING thread.

    The simulator's rank context is thread-local (each rank of a
    :func:`run` job is one thread). A library helper thread a rank
    spawns — the elastic tier's heartbeat sender — has no context and
    would otherwise Send as a world-of-one rank 0. Binding gives it the
    owning rank's identity on the SAME communicator; the thread may then
    use the full P2P surface. Collectives still belong to the rank's
    main thread (two threads of one rank entering a barrier would
    deadlock it)."""
    _ctx.rank = rank
    _ctx.comm = comm
    _ctx.initialized = True


# -- collectives -------------------------------------------------------------


def Barrier(comm: Comm | None = None) -> None:
    """``mpiT.Barrier``."""
    rank, _ = _require_ctx()
    c = _resolve(comm)
    c._exchange(rank, None)


def Bcast(buf, root: int = 0, comm: Comm | None = None):
    """``mpiT.Bcast``: root's buffer overwrites everyone's — the initial
    parameter sync (SURVEY.md §4.4). Returns ``buf``."""
    rank, _ = _require_ctx()
    c = _resolve(comm)
    t = _as_tensor(buf)
    vals = c._exchange(rank, t if rank == root else None)
    if rank != root:
        _check_transfer(t, vals[root])
        _deliver(t, vals[root])
    return buf


def _exchange_reduce(sendbuf, recvbuf, op: str, comm: Comm | None):
    """Shared tail of Reduce/Allreduce: exchange, reduce, copy out."""
    rank, _ = _require_ctx()
    c = _resolve(comm)
    vals = c._exchange(rank, _as_tensor(sendbuf))
    out = _REDUCERS[op](vals)
    if recvbuf is not None:
        t = _as_tensor(recvbuf)
        _check_transfer(t, out)
        _deliver(t, out)
        return recvbuf
    # A numpy program gets numpy back, as it would from the JAX package.
    return out if isinstance(sendbuf, torch.Tensor) else out.numpy()


def Reduce(sendbuf, recvbuf=None, op: str = SUM, root: int = 0,
           comm: Comm | None = None):
    """``mpiT.Reduce``: reduced value lands at ``root`` only (``None``
    elsewhere)."""
    rank, _ = _require_ctx()
    # Every rank participates in the exchange; only root reduces/copies out.
    if rank != root:
        c = _resolve(comm)
        c._exchange(rank, _as_tensor(sendbuf))
        return None
    return _exchange_reduce(sendbuf, recvbuf, op, comm)


def Allreduce(sendbuf, recvbuf=None, op: str = SUM, comm: Comm | None = None):
    """``mpiT.Allreduce`` — the sync-DP primitive (SURVEY.md §4.3).
    Returns ``recvbuf``, or, when it is ``None``, the result: a tensor
    for a tensor ``sendbuf``, a numpy array otherwise."""
    return _exchange_reduce(sendbuf, recvbuf, op, comm)


# ---------------------------------------------------------------------------
# Launcher — the `mpirun -n P` analogue.
# ---------------------------------------------------------------------------


def run(
    fn: Callable[..., Any],
    nranks: int,
    *,
    pass_rank: bool = False,
    timeout: float | None = 120.0,
    fault_plan=None,
) -> list[Any]:
    """Run ``fn`` on ``nranks`` simulated ranks — the ``mpirun -n P`` analogue.

    Each rank is a thread with its own rank context; ``fn`` is called with no
    arguments (query :func:`Comm_rank` inside, reference-style) or with the
    rank if ``pass_rank``. Returns each rank's return value, rank-ordered.
    Exceptions on any rank abort the whole "job" (as a dead rank aborts an
    ``mpirun`` job) and the root-cause error re-raises on the caller.
    ``timeout`` bounds the *total* job wall-clock; a timeout dumps every
    rank's mailbox state (pending/posted per rank, dups included) to
    stderr before aborting — the deadlock watchdog:
    a hung job names who was parked on what.

    ``fault_plan`` (:class:`mpit_tpu_torch.compat.faults.FaultPlan`) installs
    seeded message faults on the job's wire — ``Send`` consults it (and
    every ``Comm_dup`` inherits it); step-level faults are the training
    wrapper's to apply via ``plan.step_action``.
    """
    import time

    world = Comm(nranks, name="world")
    world._fault_plan = fault_plan
    results: list[Any] = [None] * nranks
    errors: list[BaseException | None] = [None] * nranks

    def runner(r: int) -> None:
        _ctx.rank = r
        _ctx.comm = world
        _ctx.initialized = False
        try:
            results[r] = fn(r) if pass_rank else fn()
        except BaseException as e:  # noqa: BLE001 — surfaced to caller below
            errors[r] = e
            # Unblock peers stuck in a collective or a blocking receive: a
            # dead MPI rank aborts the whole mpirun job.
            world.abort()

    threads = [
        threading.Thread(
            target=runner, args=(r,), name=f"mpit-rank-{r}", daemon=True
        )
        for r in range(nranks)
    ]
    for t in threads:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    timed_out = False
    for t in threads:
        t.join(
            None if deadline is None else max(0.0, deadline - time.monotonic())
        )
        if t.is_alive():
            if not timed_out:
                # Deadlock watchdog dump BEFORE the abort wipes the
                # evidence: which rank holds/awaits what.
                import json as _json
                import sys as _sys

                print(
                    "[compat] job timeout — per-rank mailbox state:\n"
                    + _json.dumps(world.describe(), indent=1, default=str),
                    file=_sys.stderr,
                )
            timed_out = True
            world.abort()

    def _raise_first(pred) -> None:
        for e in errors:
            if e is not None and pred(e):
                raise e

    # The root-cause rank error, if any, beats the secondary wakeup errors
    # (BrokenBarrierError / AbortedError on peers) and beats a timeout.
    _raise_first(
        lambda e: not isinstance(e, (threading.BrokenBarrierError, AbortedError))
    )
    if timed_out:
        raise TimeoutError(f"rank thread(s) did not finish in {timeout}s")
    _raise_first(lambda e: True)
    return results
