"""Parameter-server actors, ``pserver.lua`` / ``pclient.lua`` redone:
the port of :mod:`mpit_tpu.asyncsgd.actors`.

The server rank owns the canonical flat parameter vector and the goo
state and serves tagged client messages from ``ANY_SOURCE``; each client
pushes gradients (Downpour) or exchanges elastic differences (EASGD)
and pulls fresh parameters. The actors run on the port's compat
simulator (:mod:`mpit_tpu_torch.compat`, one thread a rank). The flat
vectors (parameters, gradients, the goo state) lie on the run's device:
on the card every flat message is a send snapshot and a delivery, each
a launch of the KV copy kernel (:func:`mpit_tpu_torch.ops.kv_ship.ship_bytes`),
and never leaves the card. The ``int32[1]`` control messages stay on the
CPU (compat refuses a message that changes device).

Ordering on the card: every rank thread launches on the device's
default stream, so work runs in the order the threads enqueue it. The
EASGD server enqueues the snapshot of its centre for the reply before
it moves the centre, from its own thread; a delivery is enqueued before
the receiver's ``Wait`` returns, so a client never reads a buffer ahead
of its copy.

=========  ===========================  =============================
tag        payload (client → server)    server reply
=========  ===========================  =============================
TAG_FETCH  ``[step]`` int32             params (``TAG_PARAM``)
TAG_GRAD   flat gradient                — (Downpour: apply goo)
TAG_DELTA  flat client params           pre-update centre (``TAG_PARAM``);
                                        then x̃ ← x̃ + α·(xᵢ − x̃)
TAG_STOP   ``[step]`` int32             — (exit after one per client)
=========  ===========================  =============================
"""

from __future__ import annotations

from typing import Callable

import torch

from mpit_tpu_torch import compat as mpiT
from mpit_tpu_torch.obs import core as _obs

__all__ = [
    "SERVER_RANK", "TAG_DELTA", "TAG_FETCH", "TAG_GRAD", "TAG_PARAM", "TAG_STOP",
    "PClient", "pserver", "run_parameter_server",
]

TAG_FETCH = 11
TAG_PARAM = 12
TAG_GRAD = 13
TAG_DELTA = 14
TAG_STOP = 15

SERVER_RANK = 0  # rank 0 serves (the rank-role convention)

# Tag names for the ps_msgs counters, derived from the constants.
_TAG_NAMES = {TAG_FETCH: "fetch", TAG_PARAM: "param", TAG_GRAD: "grad",
              TAG_DELTA: "delta", TAG_STOP: "stop"}


def _ctrl(step: int) -> torch.Tensor:
    return torch.tensor([step], dtype=torch.int32)


@torch.no_grad()
def pserver(init_flat: torch.Tensor, tx, *, nclients: int,
            easgd_alpha: float = 0.125) -> torch.Tensor:
    """The server actor: serve until every client sent ``TAG_STOP``.

    ``init_flat`` is the initial flat parameter vector (copied, on its
    device); ``tx`` the goo rule applied to pushed gradients (Downpour,
    optax's form: ``p + update``); ``easgd_alpha`` the centre's pull for
    ``TAG_DELTA`` exchanges. Returns the final parameter (or EASGD
    centre) vector."""
    params = init_flat.clone()
    opt_state = tx.init([params])
    grad_buf = torch.empty_like(params)
    ctrl_buf = torch.empty((1,), dtype=torch.int32)

    stops = 0
    while stops < nclients:
        with _obs.span("pserver:probe_wait"):
            st = mpiT.Probe(mpiT.ANY_SOURCE, mpiT.ANY_TAG)
        _obs.counter("ps_msgs", 1, role="server", kind=_TAG_NAMES.get(st.tag, str(st.tag)))
        if st.tag == TAG_FETCH:
            mpiT.Recv(ctrl_buf, src=st.source, tag=TAG_FETCH)
            mpiT.Send(params, dest=st.source, tag=TAG_PARAM)
        elif st.tag == TAG_GRAD:
            mpiT.Recv(grad_buf, src=st.source, tag=TAG_GRAD)
            with _obs.span("pserver:apply_grad"):
                (update,) = tx.update([grad_buf], opt_state, [params])
                params.add_(update)
        elif st.tag == TAG_DELTA:
            mpiT.Recv(grad_buf, src=st.source, tag=TAG_DELTA)
            # Reply with the pre-update centre (the send snapshots it);
            # both sides then move from the same (x_i, x̃) pair.
            mpiT.Send(params, dest=st.source, tag=TAG_PARAM)
            params.add_(grad_buf.sub_(params).mul_(easgd_alpha))
        elif st.tag == TAG_STOP:
            mpiT.Recv(ctrl_buf, src=st.source, tag=TAG_STOP)
            stops += 1
        else:  # consume the unknown message, then fail loudly
            mpiT.Recv(torch.empty(st.count, dtype=params.dtype, device=params.device),
                      src=st.source, tag=st.tag)
            raise RuntimeError(f"pserver: unexpected tag {st.tag} from {st.source}")
    return params


class PClient:
    """The client proxy linked into a worker's training loop.

    ``fetch()`` pulls fresh parameters into the client's receive buffer
    and returns that buffer (copy it before the next fetch);
    ``push_grad()`` sends a gradient (Downpour); ``elastic_exchange()``
    runs one EASGD round trip. ``fetch`` posts the receive before the
    request's send, and the gradient's buffered ``Isend`` overlaps the
    next fetch: the reference's ``Isend``/``Irecv`` shape."""

    def __init__(self, flat_dim: int, *, device="cpu", dtype=torch.float32,
                 server: int = SERVER_RANK):
        self._server = server
        self._param_buf = torch.empty((flat_dim,), dtype=dtype, device=device)
        self._step = 0

    def fetch(self) -> torch.Tensor:
        _obs.counter("ps_msgs", 1, role="client", kind="fetch")
        with _obs.span("pclient:fetch"):
            req = mpiT.Irecv(self._param_buf, src=self._server, tag=TAG_PARAM)
            mpiT.Isend(_ctrl(self._step), dest=self._server, tag=TAG_FETCH)
            mpiT.Wait(req)
        return self._param_buf

    def push_grad(self, flat_grad: torch.Tensor) -> None:
        self._step += 1
        _obs.counter("ps_msgs", 1, role="client", kind="grad")
        with _obs.span("pclient:push_grad"):
            mpiT.Isend(flat_grad, dest=self._server, tag=TAG_GRAD)

    @torch.no_grad()
    def elastic_exchange(self, flat_params: torch.Tensor, alpha: float) -> torch.Tensor:
        """One EASGD round trip; returns the client's pulled parameters
        ``x − α·(x − x̃)`` (a new tensor)."""
        self._step += 1
        _obs.counter("ps_msgs", 1, role="client", kind="delta")
        with _obs.span("pclient:elastic_exchange"):
            req = mpiT.Irecv(self._param_buf, src=self._server, tag=TAG_PARAM)
            mpiT.Isend(flat_params, dest=self._server, tag=TAG_DELTA)
            mpiT.Wait(req)
        return flat_params - alpha * (flat_params - self._param_buf)

    def stop(self) -> None:
        mpiT.Isend(_ctrl(self._step), dest=self._server, tag=TAG_STOP)


def run_parameter_server(
    init_flat: torch.Tensor,
    tx,
    client_fn: Callable[[PClient, int], object],
    *,
    nranks: int = 2,
    easgd_alpha: float = 0.125,
    timeout: float | None = 120.0,
) -> list:
    """Launch 1 pserver + ``nranks - 1`` pclients, the ``mpirun -n P``
    shape, on the compat simulator (``timeout``: the job's wall-clock
    limit, :func:`mpit_tpu_torch.compat.run`'s).

    ``client_fn(client, worker_index)`` runs on each client rank with a
    connected :class:`PClient` on ``init_flat``'s device; its return
    value lands in the result list at its rank. Rank 0's slot holds the
    server's final parameter vector."""

    def main():
        mpiT.Init()
        rank = mpiT.Comm_rank(mpiT.COMM_WORLD)
        try:
            if rank == SERVER_RANK:
                return pserver(init_flat, tx, nclients=nranks - 1, easgd_alpha=easgd_alpha)
            client = PClient(init_flat.shape[0], device=init_flat.device, dtype=init_flat.dtype)
            try:
                return client_fn(client, rank - 1)
            finally:
                client.stop()
        finally:
            mpiT.Finalize()

    return mpiT.run(main, nranks, timeout=timeout)
