"""mpit_tpu_torch's compat simulator and fault plans against the JAX
package's, on the CPU.

Every scripted mpiT program below runs under ``mpit_tpu.compat`` and
under ``mpit_tpu_torch.compat`` (numpy buffers, which the port takes as
tensors sharing their memory) and must give the same receive order,
``Status`` fields and buffers: wildcards, posted-receive matching order,
non-overtaking, ``Comm_dup`` isolation, the collectives, and the
structured timeout. The transfer checks raise the same errors, and the
port's extra device check refuses a message that would change device.
A seeded ``FaultPlan`` logs the same drop, delay and kill events in both
packages. Every job runs under a ``timeout=``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpit_tpu import compat as jcompat
from mpit_tpu_torch import compat as tcompat
from mpit_tpu_torch.compat import simulator as tsim

PACKAGES = {"jax": jcompat, "torch": tcompat}
TIMEOUT = 30.0


def _plain(x):
    """A result made comparable across the packages."""
    if isinstance(x, (tuple, list)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numpy().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (jcompat.Status, tcompat.Status)):
        return ("Status", x.source, x.tag, x.count)
    if isinstance(x, np.generic):
        return x.item()
    return x


def ring(mpiT):
    n = 4

    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        payload = np.full((3,), float(r) + 0.5, np.float64)
        buf = np.zeros((3,), np.float64)
        if r % 2 == 0:
            mpiT.Send(payload, dest=(r + 1) % n, tag=7)
            st = mpiT.Recv(buf, src=(r - 1) % n, tag=7)
        else:
            st = mpiT.Recv(buf, src=(r - 1) % n, tag=7)
            mpiT.Send(payload, dest=(r + 1) % n, tag=7)
        return buf.copy(), st

    return main, n


def isend_irecv(mpiT):
    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 0:
            req = mpiT.Isend(np.arange(5, dtype=np.float32), dest=1, tag=3)
            return mpiT.Wait(req)
        buf = np.zeros(5, np.float32)
        req = mpiT.Irecv(buf, src=0, tag=3)
        return mpiT.Wait(req), buf

    return main, 2


def wildcards_and_fifo(mpiT):
    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 0:
            for v, tag in ((1.0, 10), (2.0, 20), (3.0, 10), (4.0, 30)):
                mpiT.Send(np.array([v]), dest=1, tag=tag)
            return None
        buf = np.zeros(1)
        out = [mpiT.Recv(buf, src=0, tag=20), buf[0]]  # out of tag order
        out.append(mpiT.Probe(src=mpiT.ANY_SOURCE, tag=mpiT.ANY_TAG))
        out += [mpiT.Recv(buf, src=0, tag=10), buf[0]]  # FIFO within (src, tag)
        out += [mpiT.Recv(buf, src=mpiT.ANY_SOURCE, tag=mpiT.ANY_TAG), buf[0]]
        out += [mpiT.Recv(buf, src=0, tag=mpiT.ANY_TAG), buf[0]]
        return out

    return main, 2


def posted_receive_order(mpiT):
    """A message goes to the earliest posted matching receive at arrival,
    whatever order Wait is called in."""

    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 0:
            mpiT.Barrier()
            for v, tag in ((1.0, 1), (2.0, 2), (3.0, 1)):
                mpiT.Send(np.array([v]), dest=1, tag=tag)
            return None
        bufs = [np.zeros(1) for _ in range(3)]
        reqs = [
            mpiT.Irecv(bufs[0], src=0, tag=1),
            mpiT.Irecv(bufs[1], src=mpiT.ANY_SOURCE, tag=mpiT.ANY_TAG),
            mpiT.Irecv(bufs[2], src=0, tag=mpiT.ANY_TAG),
        ]
        mpiT.Barrier()
        sts = [mpiT.Wait(q, timeout=10.0) for q in reversed(reqs)]
        return sts, [b[0] for b in bufs]

    return main, 2


def non_overtaking(mpiT):
    """Per-(src, tag) FIFO from two senders into one ANY_SOURCE reader."""

    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r > 0:
            for i in range(4):
                mpiT.Send(np.array([10 * r + i], np.int64), dest=0, tag=5)
            return None
        got = {1: [], 2: []}
        buf = np.zeros(1, np.int64)
        for _ in range(8):
            st = mpiT.Recv(buf, src=mpiT.ANY_SOURCE, tag=5)
            got[st.source].append(int(buf[0]))
        return got

    return main, 3


def comm_dup_isolation(mpiT):
    """An ANY_TAG receive posted on the world communicator never matches
    a message sent on its dup."""

    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        dup = mpiT.Comm_dup(None, key="library")
        if r == 0:
            mpiT.Barrier()
            mpiT.Send(np.array([7.0]), dest=1, tag=5, comm=dup)
            mpiT.Send(np.array([8.0]), dest=1, tag=5)
            return None
        app = np.zeros(1)
        req = mpiT.Irecv(app, src=mpiT.ANY_SOURCE, tag=mpiT.ANY_TAG)
        mpiT.Barrier()
        lib = np.zeros(1)
        st_lib = mpiT.Recv(lib, src=0, tag=5, comm=dup)
        st_app = mpiT.Wait(req, timeout=10.0)
        return (st_lib, lib[0], st_app, app[0], dup.size, dup.name)

    return main, 2


def server_loop(mpiT):
    n = 4

    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 0:
            acc = np.zeros(2)
            for _ in range(n - 1):
                buf = np.zeros(2)
                st = mpiT.Recv(buf, src=mpiT.ANY_SOURCE, tag=1)
                acc += buf
                mpiT.Send(acc.copy(), dest=st.source, tag=2)
            return acc
        mpiT.Send(np.full(2, float(r)), dest=0, tag=1)
        buf = np.zeros(2)
        mpiT.Recv(buf, src=0, tag=2)
        return float(buf.sum() >= 2 * r)

    return main, n


def collectives(mpiT):
    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        b = np.full(3, float(r) if r == 2 else -1.0)
        mpiT.Bcast(b, root=2)
        outs = [b.copy()]
        for op in (mpiT.SUM, mpiT.MAX, mpiT.MIN, mpiT.PROD):
            recv = np.zeros(2)
            mpiT.Allreduce(np.full(2, float(r + 1)), recv, op=op)
            outs.append(recv.copy())
        outs.append(mpiT.Allreduce(np.arange(3, dtype=np.float32) * r))
        red = mpiT.Reduce(np.full(2, float(r)), op=mpiT.SUM, root=1)
        outs.append(None if red is None else red.copy())
        mpiT.Barrier()
        return outs

    return main, 4


def recv_timeout(mpiT):
    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 1:
            return None
        try:
            mpiT.Recv(np.zeros(2), src=1, tag=7, timeout=0.05)
        except mpiT.CompatTimeoutError as e:
            return (e.op, e.rank, e.src, e.tag, "src=1 tag=7" in str(e))
        return "no timeout"

    return main, 2


@pytest.mark.parametrize(
    "program",
    [ring, isend_irecv, wildcards_and_fifo, posted_receive_order,
     non_overtaking, comm_dup_isolation, server_loop, collectives,
     recv_timeout],
)
def test_scripted_program_matches_jax(program):
    got = {}
    for name, mpiT in PACKAGES.items():
        main, n = program(mpiT)
        got[name] = _plain(mpiT.run(main, n, timeout=TIMEOUT))
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize(
    "buf,err,match",
    [(np.zeros(3, np.float64), ValueError, "size"),
     (np.zeros(2, np.int32), TypeError, "dtype")],
    ids=["size", "dtype"],
)
def test_transfer_errors_match_jax(buf, err, match):
    def program(mpiT):
        def main():
            mpiT.Init()
            if mpiT.Comm_rank(mpiT.COMM_WORLD) == 0:
                mpiT.Send(np.ones(2, np.float64), dest=1, tag=0)
                return None
            mpiT.Recv(buf.copy(), src=0, tag=0)

        return main

    for mpiT in PACKAGES.values():
        with pytest.raises(err, match=match):
            mpiT.run(program(mpiT), 2, timeout=TIMEOUT)


def test_transfer_refuses_a_change_of_device():
    """A message on another device never lands in a CPU buffer (the
    meta device stands in for the card here)."""
    buf = torch.zeros(2)
    with pytest.raises(TypeError, match="device"):
        tsim._check_transfer(buf, torch.empty(2, device="meta"))
    with pytest.raises(TypeError, match="device"):
        tsim._check_transfer(torch.empty(2, device="meta"), buf)


def test_tensor_buffers_and_numpy_returns():
    """Tensor buffers are written in place; a numpy program gets numpy
    back from a reduction, a tensor program a tensor."""

    def main():
        tcompat.Init()
        r = tcompat.Comm_rank(tcompat.COMM_WORLD)
        t = tcompat.Allreduce(torch.full((2,), float(r)))
        a = tcompat.Allreduce(np.full(2, float(r)))
        buf = torch.zeros(3, dtype=torch.int64)
        if r == 0:
            tcompat.Send(torch.arange(3), dest=1, tag=1)
        else:
            tcompat.Recv(buf, src=0, tag=1)
        return type(t).__name__, type(a).__name__, buf.tolist()

    out = tcompat.run(main, 2, timeout=TIMEOUT)
    assert out[0] == ("Tensor", "ndarray", [0, 0, 0])
    assert out[1] == ("Tensor", "ndarray", [0, 1, 2])


def _fault_program(mpiT):
    def main():
        mpiT.Init()
        r = mpiT.Comm_rank(mpiT.COMM_WORLD)
        if r == 0:
            for i in range(24):
                mpiT.Send(np.array([i], np.int32), dest=1, tag=i % 3)
        return None

    return main


def test_fault_plan_logs_the_same_events_as_jax():
    """Drop and delay rules (windowed, thinned by the seeded RNG) and a
    step kill: the same plan and seed log the same events."""
    logs = {}
    for name, mpiT in PACKAGES.items():
        plan = mpiT.FaultPlan(
            seed=3,
            message_rules=[
                mpiT.MessageRule("drop", src=0, tag=1, prob=0.5),
                mpiT.MessageRule("delay", tag=2, after=2, count=4, delay_s=0.001),
                mpiT.MessageRule("drop", dst=1, prob=0.3),
            ],
            kill_at={1: 3},
            slowdown={0: mpiT.Slowdown(0.25, start=1, stop=3)},
        )
        mpiT.run(_fault_program(mpiT), 2, timeout=TIMEOUT, fault_plan=plan)
        actions = [plan.step_action(0, s) for s in range(4)]
        with pytest.raises(mpiT.ReplicaKilled):
            plan.step_action(1, 3)
        plan.step_action(1, 3)  # fires once
        logs[name] = (plan.events(), [a.sleep_s for a in actions])
    assert logs["torch"] == logs["jax"]
    assert any(e[0] == "drop" for e in logs["torch"][0])
    assert any(e[0] == "delay" for e in logs["torch"][0])
