"""The collectives the training step and the parallel tiers use, over a
World's rank-stacked tensors: the port of the subset of
:mod:`mpit_tpu.comm.collectives` (and of ``lax.psum``, ``lax.ppermute``
and ``lax.all_to_all``) that the data-parallel step,
:mod:`mpit_tpu_torch.parallel.megatron`, the FSDP cut of
:mod:`mpit_tpu_torch.parallel.tp` and the context-parallel attention of
:mod:`mpit_tpu_torch.parallel.ring_attention` and
:mod:`~mpit_tpu_torch.parallel.ulysses` call.

Every function takes a tensor whose leading dimension is the rank and
returns one of the same layout, row ``r`` being rank ``r``'s result;
:func:`gather_shards` and :func:`scatter_sum` name the dimension that
holds one axis' ranks of a several-axis World instead.
They are plain PyTorch reductions over the rank dimension: the port's
``psum`` mode, standing where XLA's stock collectives stand in the JAX
package. :func:`rank_sum` (``lax.psum``) adds the ranks one after the
other in rank order. Wire bytes are charged to the obs counter
``collective_bytes`` when obs is on.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch import obs

__all__ = [
    "all_to_all", "allgather", "gather_shards", "pmean", "rank_sum", "reduce_scatter",
    "scatter_sum", "shift",
]


def _charge(name: str, x) -> None:
    obs.counter("collective_bytes", float(x[0].numel() * x.element_size()), collective=name)


def rank_sum(xs):
    """The all-reduce sum (JAX ``lax.psum``) of ``xs`` ``[p, ...]``, the
    ranks added one after the other in rank order: what every rank holds
    after it, held once (a replicated value of the World)."""
    _charge("psum", xs)
    acc = xs[0]
    for r in range(1, xs.shape[0]):
        acc = acc + xs[r]
    return acc


def pmean(xs):
    """Mean over the ranks (the sum divided by ``p``), every rank
    receiving it: the gradient-averaging allreduce."""
    _charge("pmean", xs)
    return (xs.sum(0, keepdim=True) / xs.shape[0]).expand_as(xs).clone()


def reduce_scatter(xs, *, scatter_axis: int | None = None):
    """``xs [p, n, ...]`` (``n`` divisible by ``p``) → ``[p, n/p, ...]``:
    rank ``r`` receives slice ``r`` of the sum over the ranks (the
    ZeRO-1 gradient scatter). ``scatter_axis`` (JAX's ``scatter_axis``)
    names the dimension of each rank's tensor that is cut instead of its
    first: there the sum is :func:`rank_sum`'s, in rank order (the
    Megatron-SP exit cuts the sequence)."""
    if scatter_axis is not None:
        p, axis = xs.shape[0], scatter_axis % (xs.dim() - 1)
        n = xs.shape[axis + 1]
        if n % p:
            raise ValueError(f"dim {axis} ({n}) is not divisible by the {p} ranks")
        return torch.stack(rank_sum(xs).chunk(p, dim=axis))
    p, n = xs.shape[:2]
    if n % p:
        raise ValueError(f"dim 1 ({n}) is not divisible by the {p} ranks")
    _charge("reduce_scatter", xs)
    return xs.reshape(p, p, n // p, *xs.shape[2:]).sum(0)


def allgather(shards, *, gather_axis: int | None = None):
    """``shards [p, m, ...]`` → ``[p, p·m, ...]``: every rank receives the
    concatenation of the shards in rank order. ``gather_axis`` (JAX's
    tiled ``gather_axis``) names the dimension of each rank's tensor that
    the shards are joined on instead of its first; the rows are then one
    broadcast view of the whole: read them, do not write them."""
    if gather_axis is not None:
        _charge("allgather", shards)
        full = torch.cat(list(shards), dim=gather_axis % (shards.dim() - 1))
        return full.expand(shards.shape[0], *full.shape)
    p, m = shards.shape[:2]
    _charge("allgather", shards)
    full = shards.reshape(1, p * m, *shards.shape[2:])
    return full.expand(p, *full.shape[1:]).clone()


def gather_shards(x, *, rank_dim: int, dim: int):
    """The rank-order all-gather over one axis of a several-axis World:
    ``x`` holds that axis' shards at ``rank_dim`` (its other leading
    dimensions are other axes' ranks); returns them joined in rank order
    along ``dim``, a dimension of the result, which has no ``rank_dim``
    (the whole, held once over that axis). :func:`scatter_sum` is its
    adjoint."""
    _charge("allgather", x.movedim(rank_dim, 0))
    return torch.cat(x.unbind(rank_dim), dim=dim)


def scatter_sum(xs, p: int, *, rank_dim: int, dim: int):
    """The reduce-scatter that is :func:`gather_shards`' adjoint: the
    terms ``xs`` (one whole tensor from each rank of the reducing axis,
    e.g. each data rank's gradient) summed in rank order, then cut into
    ``p`` shards along ``dim`` and stacked at ``rank_dim``."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    if acc.shape[dim] % p:
        raise ValueError(f"dim {dim} ({acc.shape[dim]}) is not divisible by the {p} ranks")
    return torch.stack(acc.chunk(p, dim=dim), dim=rank_dim)


def shift(x, offset: int = 1):
    """The ring shift (JAX's ``C.shift``, a ``lax.ppermute`` of ``i → i
    + offset``) as an index operation on the rank dimension: rank ``i``
    receives rank ``i - offset``'s row (mod ``p``)."""
    _charge("shift", x)
    return torch.roll(x, offset, dims=0)


def all_to_all(x, *, split_axis: int, concat_axis: int):
    """JAX's tiled ``lax.all_to_all`` as a reshape and a transpose of the
    rank dimension: each rank cuts its tensor into ``p`` pieces along
    ``split_axis`` and sends piece ``j`` to rank ``j``; rank ``i`` joins
    the pieces it receives in the senders' rank order along
    ``concat_axis`` (both axes of each rank's tensor, without the rank
    dimension). ``[p, B, T/p, H, D]`` with ``split_axis=2,
    concat_axis=1`` gives ``[p, B, T, H/p, D]`` (Ulysses' head re-shard);
    the swapped axes invert it."""
    p, shape = x.shape[0], list(x.shape[1:])
    nd = len(shape)
    sa, ca = split_axis % nd, concat_axis % nd
    if shape[sa] % p:
        raise ValueError(f"split axis {sa} ({shape[sa]}) is not divisible by the {p} ranks")
    _charge("all_to_all", x)
    # [src, e_0 .. e_{sa-1}, dest, e_sa / p, e_{sa+1} ..]
    y = x.reshape(p, *shape[:sa], p, shape[sa] // p, *shape[sa + 1:])
    per_rank = [*range(1, sa + 1), sa + 2, *range(sa + 3, nd + 2)]
    perm = [sa + 1]
    for j, d in enumerate(per_rank):
        if j == ca:
            perm.append(0)  # the senders, in rank order, just before the joined axis
        perm.append(d)
    shape[sa] //= p
    shape[ca] *= p
    return y.permute(perm).reshape(p, *shape)
