"""A JAX training state carried into the port.

The training part of :mod:`mpit_tpu.train.convert`:
:func:`train_state_from_jax` takes the JAX package's params, optax
optimizer state and step (numpy trees: ``jax.tree.map(np.asarray,
...)``) and builds the port's :class:`~mpit_tpu_torch.train.step.TrainState`.
Params map through :func:`mpit_tpu_torch.serve.weights.params_from_jax`
(the same names and layouts); optax's Adam ``ScaleByAdamState(count,
mu, nu)`` becomes :class:`~mpit_tpu_torch.opt.goo.AdamState` and goo's
``GooState(momentum, count)`` :class:`~mpit_tpu_torch.opt.goo.GooState`,
moment for moment under the parameters' names. A moment may be a tree
like the params (replicated state) or the flat vector of the JAX
package's ZeRO-1 layout (each leaf raveled in the tree's sorted-key
order and zero-padded to a multiple of 128).

With a ``world`` of ``p`` ranks the state is the data-parallel step's:
the params once per rank, and every moment rank-stacked in the flat
layout. A ZeRO-1 moment, JAX's global ``[p·S]`` vector, is cut into its
``p`` contiguous shards (``[p, S]``, rank ``r`` holding ``[r·S,
(r+1)·S)``, :func:`mpit_tpu_torch.opt.sharded.shard_of`'s layout); a
replicated moment tree becomes ``[p, N]``, its flat vector on every
rank.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mpit_tpu_torch.opt.goo import AdamState, GooState
from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
from mpit_tpu_torch.serve.weights import params_from_jax
from mpit_tpu_torch.train.step import TrainState

__all__ = ["flat_unravel", "train_state_from_jax"]

_LANE = 128  # the ZeRO-1 layout's per-leaf alignment


def _leaves(tree: Mapping, prefix: str = ""):
    """``(path, leaf)`` in JAX's leaf order: dict keys sorted."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, path + "/")
        else:
            yield path, val


def flat_unravel(flat, like: Mapping) -> dict:
    """The inverse of the JAX package's lane-aligned ``flat_ravel``: the
    flat vector (possibly longer: the shard padding) as a nested tree
    shaped like ``like``."""
    flat = np.asarray(flat).reshape(-1)
    out: dict = {}
    off = 0
    for path, leaf in _leaves(like):
        shape = np.shape(leaf)
        size = int(np.prod(shape)) if shape else 1
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if off + size > flat.shape[0]:
            raise ValueError(f"flat vector of {flat.shape[0]} ends inside leaf {path!r}")
        node[parts[-1]] = flat[off : off + size].reshape(shape)
        off += size + (-size) % _LANE
    return out


def _moment(tree, params: Mapping) -> dict:
    """A moment tree or flat ZeRO-1 vector as a name → tensor mapping."""
    if not isinstance(tree, Mapping):
        tree = flat_unravel(tree, params)
    return params_from_jax(tree)


def _stacked_moment(tree, state: Mapping, p: int):
    """A moment as the p-rank step's rank-stacked buffer: a flat ZeRO-1
    vector → its ``[p, S]`` shards, a replicated tree → ``[p, N]``."""
    layout = FlatLayout(state)
    n = padded_len(layout.total, p)
    if isinstance(tree, Mapping):
        flat = torch.zeros(n)
        layout.ravel(params_from_jax(tree), out=flat)
        return flat.expand(p, n).clone()
    flat = torch.from_numpy(np.array(np.asarray(tree).reshape(-1), dtype=np.float32))
    if flat.shape[0] != n:
        raise ValueError(
            f"a ZeRO-1 moment of {flat.shape[0]} elements; {p} ranks of this "
            f"model hold {n} (flat length {layout.total} padded to {p}·128)"
        )
    return flat.view(p, n // p)


def _find(state, fields: tuple[str, ...]):
    """The first node of an optax state (nested tuples / named tuples)
    that has all of ``fields``."""
    if all(hasattr(state, f) for f in fields):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find(sub, fields)
            if found is not None:
                return found
    return None


def train_state_from_jax(params: Mapping, opt_state: Any, step, *, world=None) -> TrainState:
    """The port's :class:`TrainState` from JAX's params, optax state and
    step. ``opt_state`` holds an Adam state (``count``, ``mu``, ``nu``:
    ``goo_adam``) or a goo SGD state (``momentum``, ``count``); an SGD
    state without momentum (``()``) or without a schedule count maps to
    ``None`` there. The returned params are CPU tensors:
    :meth:`TrainState.bind` loads them into a model (a list of models,
    one per rank, with a ``world``)."""
    state = params_from_jax(params)
    p = None if world is None else world.num_devices

    def moment(tree):
        if p is not None:
            return [_stacked_moment(tree, state, p)]
        buf = _moment(tree, params)
        return {n: buf[n] for n in state}

    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        opt = AdamState(count=int(np.asarray(adam.count)), mu=moment(adam.mu),
                        nu=moment(adam.nu))
    else:
        sgd = _find(opt_state, ("momentum", "count"))
        if sgd is None:
            raise ValueError(
                "opt_state holds neither an optax Adam state (count, mu, nu) "
                "nor a goo SGD state (momentum, count)"
            )
        momentum = None
        if not (isinstance(sgd.momentum, tuple) and not sgd.momentum):
            momentum = moment(sgd.momentum)
        count = sgd.count
        opt = GooState(
            momentum=momentum,
            count=None if isinstance(count, tuple) else int(np.asarray(count)),
        )
    ranks_params = state if p is None else [dict(state) for _ in range(p)]
    return TrainState(step=int(np.asarray(step)), params=ranks_params, opt_state=opt)
