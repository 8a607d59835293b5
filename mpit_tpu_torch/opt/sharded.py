"""ZeRO-1 sharding of the optimizer over a World's ranks: the port of
:mod:`mpit_tpu.opt.sharded`.

Every rank holds ``1/p`` of the flattened optimizer state, and a step is

    reduce-scatter(grads) → update the own shard → all-gather(updates)

The flat layout is the JAX package's, element for element, so the
shards, their padding and a carried-over JAX state line up:

- :func:`flat_ravel` / :class:`FlatLayout` — the parameters in the JAX
  tree's leaf order (dict keys sorted at every level; the port's names
  are the tree's paths with ``.`` for ``/`` and ``blocks.<i>`` for
  ``block_<i>``, :func:`mpit_tpu_torch.serve.weights.params_from_jax`),
  each leaf raveled and zero-padded to a multiple of 128 (``LANE``);
- :func:`padded_len` — the flat vector padded to a multiple of ``p·128``;
- :func:`shard_of` — rank ``r``'s contiguous shard ``[r·S, (r+1)·S)``.

The collectives run on rank-stacked tensors (row ``r`` rank ``r``'s):
:func:`sharded` wraps a goo rule so that ``init`` builds the ``[p, S]``
shards of its state and ``update`` takes the ranks' ``[p, N]`` flat
gradients and returns their ``[p, N]`` flat updates, identical on every
rank. The rule must be elementwise (the goo family is).
"""

from __future__ import annotations

from typing import Mapping

import torch

from mpit_tpu_torch.comm import collectives as C

__all__ = ["LANE", "FlatLayout", "flat_len", "flat_ravel", "padded_len", "shard_of", "sharded"]

LANE = 128


def padded_len(size: int, n: int) -> int:
    """Length of a flat vector of ``size`` padded for an ``n``-way shard:
    the one ZeRO-1 pad multiple, ``n·LANE``."""
    return size + ((-size) % (n * LANE))


def _leaf_padded(size: int) -> int:
    return size + ((-size) % LANE)


def _jax_key(name: str) -> tuple[str, ...]:
    """A port parameter name as the JAX tree path it came from."""
    parts = name.split(".")
    if parts[0] == "blocks" and len(parts) > 1:
        parts = [f"block_{parts[1]}", *parts[2:]]
    return tuple(parts)


class FlatLayout:
    """Where each leaf of a name → tensor mapping sits in the flat
    vector: JAX's leaf order, every leaf at a LANE-aligned offset.
    ``total`` is the flat length (:func:`flat_len`)."""

    def __init__(self, tree: Mapping):
        self.names = sorted(tree, key=_jax_key)
        self.shapes = {n: tuple(tree[n].shape) for n in self.names}
        self.offsets = {}
        off = 0
        for n in self.names:
            self.offsets[n] = off
            off += _leaf_padded(_numel(self.shapes[n]))
        self.total = off

    def views(self, flat) -> dict:
        """The leaves as views of ``flat`` (at least ``total`` long)."""
        return {
            n: flat[self.offsets[n] : self.offsets[n] + _numel(self.shapes[n])].view(self.shapes[n])
            for n in self.names
        }

    def ravel(self, tree: Mapping, out=None):
        """``tree``'s leaves in one flat vector (``out``, or a new zeroed
        one of ``total``); the pads stay as they are in ``out``."""
        if out is None:
            first = tree[self.names[0]]
            out = torch.zeros(self.total, dtype=first.dtype, device=first.device)
        views = self.views(out)
        for n in self.names:
            views[n].copy_(tree[n])
        return out


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def flat_len(tree: Mapping) -> int:
    """Length of :func:`flat_ravel`'s output (sum of LANE-padded leaves)."""
    return FlatLayout(tree).total


def flat_ravel(tree: Mapping):
    """Lane-aligned ravel, JAX's leaf order: ``(flat, unravel)``,
    ``unravel(v)`` giving the leaves as views of ``v`` under their names."""
    layout = FlatLayout(tree)
    return layout.ravel(tree), layout.views


def shard_of(flat):
    """Each rank's contiguous shard of rank-stacked flat vectors ``[p,
    n]``: padded to a ``p·LANE`` multiple, rank ``r`` takes ``[r·S,
    (r+1)·S)`` of its own row. A ``[p, S]`` view when no pad is needed."""
    p, n = flat.shape
    padded = padded_len(n, p)
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    s = padded // p
    return flat.view(p, p, s).diagonal(dim1=0, dim2=1).t()


class _Sharded:
    def __init__(self, tx, world, mean_grads: bool, comm):
        self.tx, self.world, self.mean_grads, self.comm = tx, world, mean_grads, comm

    def init(self, flat_params):
        """The rule's state over every rank's shard: ``[p, S]`` buffers
        (JAX's ``tx.init`` of each device's shard: an elastic centre
        starts at it)."""
        return self.tx.init([shard_of(flat_params).clone(memory_format=torch.contiguous_format)])

    @torch.no_grad()
    def update(self, flat_grads, state, flat_params):
        """``[p, N]`` local (unreduced) gradients → ``[p, N]`` updates, the
        state's shards advanced in place. The cross-rank sum rides the
        reduce-scatter; ``mean_grads`` divides it by ``p``. A rule that
        averages the parameters over the ranks (``elastic_average``)
        also gets ``replicas=flat_params``: the JAX package hands it only
        each device's shard, so its ``pmean`` there averages shard ``r``
        of one device with shard ``s`` of another (ROADMAP.md §C); here
        the rule averages each shard over the replicas."""
        p, size = flat_grads.shape
        if p != self.world.num_devices:
            raise ValueError(f"{p} ranks of gradients for a World of {self.world.num_devices}")
        if self.comm is None:
            padded = torch.nn.functional.pad(flat_grads, (0, padded_len(size, p) - size))
            g = C.reduce_scatter(padded.view(p, -1, LANE)).reshape(p, -1)
            p_shard = shard_of(flat_params)
        else:
            g = self.comm.scatter_grads(flat_grads)
            p_shard = self.comm.param_shard(flat_params)
        if self.mean_grads:
            g = g / p
        kw = {"replicas": flat_params} if getattr(self.tx, "takes_replicas", False) else {}
        (u,) = self.tx.update([g], state, [p_shard], **kw)
        if self.comm is None:
            return C.allgather(u.reshape(p, -1, LANE)).reshape(p, -1)[:, :size]
        return self.comm.gather_updates(u, size)


def sharded(tx, world, *, mean_grads: bool = True, comm=None) -> _Sharded:
    """Wrap the elementwise goo rule ``tx`` so its state lives in ``[p,
    S]`` shards over ``world``'s ranks. ``comm``: a
    :class:`~mpit_tpu_torch.train.grad_sync.GradSync` carrying the
    reduce-scatter, shard selection and all-gather (the ring tiers);
    ``None`` uses the plain collectives. Every choice gives the same
    shard layout, so the state is interchangeable between them."""
    return _Sharded(tx, world, mean_grads, comm)
