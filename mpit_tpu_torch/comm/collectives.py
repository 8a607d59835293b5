"""The collectives the training step uses, over a World's rank-stacked
tensors: the port of the subset of :mod:`mpit_tpu.comm.collectives`
that the data-parallel step calls.

Every function takes a tensor whose leading dimension is the rank and
returns one of the same layout, row ``r`` being rank ``r``'s result.
They are plain PyTorch reductions over the rank dimension, summing the
ranks in rank order: the port's ``psum`` gradient-sync mode, standing
where XLA's stock collectives stand in the JAX package. Wire bytes are
charged to the obs counter ``collective_bytes`` when obs is on.
"""

from __future__ import annotations

from mpit_tpu_torch import obs

__all__ = ["allgather", "pmean", "reduce_scatter"]


def _charge(name: str, x) -> None:
    obs.counter("collective_bytes", float(x[0].numel() * x.element_size()), collective=name)


def pmean(xs):
    """Mean over the ranks (the sum divided by ``p``), every rank
    receiving it: the gradient-averaging allreduce."""
    _charge("pmean", xs)
    return (xs.sum(0, keepdim=True) / xs.shape[0]).expand_as(xs).clone()


def reduce_scatter(xs):
    """``xs [p, n, ...]`` (``n`` divisible by ``p``) → ``[p, n/p, ...]``:
    rank ``r`` receives slice ``r`` of the sum over the ranks (the
    ZeRO-1 gradient scatter)."""
    p, n = xs.shape[:2]
    if n % p:
        raise ValueError(f"dim 1 ({n}) is not divisible by the {p} ranks")
    _charge("reduce_scatter", xs)
    return xs.reshape(p, p, n // p, *xs.shape[2:]).sum(0)


def allgather(shards):
    """``shards [p, m, ...]`` → ``[p, p·m, ...]``: every rank receives the
    concatenation of the shards in rank order."""
    p, m = shards.shape[:2]
    _charge("allgather", shards)
    full = shards.reshape(1, p * m, *shards.shape[2:])
    return full.expand(p, *full.shape[1:]).clone()
