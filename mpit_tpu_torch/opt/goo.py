"""The "goo" update rules: Torch-semantics SGD and Adam(W), with explicit
state.

The port of :mod:`mpit_tpu.opt.goo`, whose rules are optax gradient
transformations. Here a rule is an object with ``init(params) -> state``,
``step(params, grads, state)`` and optax's ``update(grads, state,
params) -> updates``. ``params`` is a mapping of name to
tensor (or a list); ``grads`` a mapping with the same names or a list
in ``params``' order; the state's moment buffers are mappings keyed by
the same names (lists for list params), so they map one to one onto
optax's state leaves. The step updates ``params`` and ``state``
IN PLACE under ``torch.no_grad()``: JAX rebuilds both every step,
PyTorch need not. ``update`` advances the state in place and returns
the updates ``u`` for the caller to add (``p + u``, optax's
``apply_updates``): the ZeRO-1 step gathers updates, not parameters. The arithmetic is optax's, element for element:

- :func:`goo` — ``g ← g + wd·p``; ``b ← μ·b + (1 − damp)·g`` (b starts
  at zero); ``g ← g + μ·b`` with Nesterov, else ``b``; ``p ← p − lr·g``.
  State :class:`GooState` ``(momentum, count)``: no buffers without
  momentum, no count for a constant lr.
- :func:`goo_adam` — optax ``adam`` (``adamw`` when ``weight_decay`` is
  non-zero, with no mask, as optax has none by default): state
  :class:`AdamState` ``(count, mu, nu)``, one for one with optax's
  ``ScaleByAdamState``.

- :func:`elastic_average` — the EASGD elastic term, chained after a
  base rule (:func:`chain`): the worker pull ``u ← u − α·(p − c)`` on
  top of the base rule's update, and the centre step ``c ← c + β·(x̄ −
  c)``, ``x̄`` the mean over the ranks of the post-step parameters
  ``p + u``. State :class:`ElasticState` ``(center)``.
- :func:`chain` — optax's ``chain`` for the goo rules: the updates pass
  through each rule in turn, the state is the tuple of theirs.

A learning rate is a constant or a schedule ``count -> lr``
(:mod:`mpit_tpu_torch.opt.schedules`), called with the count before the
step increments it. Counts are host integers: a schedule never waits on
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpit_tpu_torch.opt.schedules import LearningRate

__all__ = [
    "AdamState", "ElasticState", "GooState", "chain", "elastic_average", "goo", "goo_adam",
]


@dataclasses.dataclass
class GooState:
    """Momentum buffers (None without momentum) and the schedule count
    (None for a constant lr)."""

    momentum: list | None
    count: int | None = None


@dataclasses.dataclass
class ElasticState:
    """The EASGD centre variable x̃, the pserver's canonical parameters:
    a mapping or list like the parameters it was made from."""

    center: Mapping | list


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the first and
    second moments."""

    count: int
    mu: list
    nu: list


def _lr_at(lr: LearningRate, count: int | None) -> float:
    return lr(count) if callable(lr) else lr


def _zeros_like(params):
    if isinstance(params, Mapping):
        return {name: torch.zeros_like(p) for name, p in params.items()}
    return [torch.zeros_like(p) for p in params]


def _tensors(x, names):
    """``x``'s tensors in ``names`` order (``names`` None: a list as is)."""
    if isinstance(x, Mapping):
        return [x[n] for n in names]
    return list(x)


def _names(params):
    return list(params) if isinstance(params, Mapping) else None


def _restructure(tensors, names):
    """``tensors`` as a mapping under ``names``, or the list (names None)."""
    return dict(zip(names, tensors)) if names is not None else list(tensors)


class _Goo:
    def __init__(self, lr, momentum, nesterov, weight_decay, dampening):
        if nesterov and (momentum == 0.0 or dampening != 0.0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening == 0 "
                "(matching torch.optim.SGD's guard)"
            )
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.weight_decay, self.dampening = weight_decay, dampening

    def init(self, params) -> GooState:
        count = 0 if callable(self.lr) else None
        if self.momentum == 0.0:
            return GooState(momentum=None, count=count)
        return GooState(momentum=_zeros_like(params), count=count)

    def _direction(self, params, grads, state: GooState, names):
        """The step before the learning rate: ``g (+ wd·p)`` through the
        momentum buffers (advanced in place)."""
        grads = _tensors(grads, names)
        if self.weight_decay != 0.0:
            grads = torch._foreach_add(grads, _tensors(params, names), alpha=self.weight_decay)
        if self.momentum == 0.0:
            return grads
        buf = _tensors(state.momentum, names)
        torch._foreach_mul_(buf, self.momentum)
        torch._foreach_add_(buf, grads, alpha=1.0 - self.dampening)
        return torch._foreach_add(grads, buf, alpha=self.momentum) if self.nesterov else buf

    @torch.no_grad()
    def step(self, params, grads, state: GooState) -> GooState:
        lr_t = _lr_at(self.lr, state.count)
        names = _names(params)
        step = self._direction(params, grads, state, names)
        torch._foreach_add_(_tensors(params, names), step, alpha=-lr_t)
        if state.count is not None:
            state.count += 1
        return state

    @torch.no_grad()
    def update(self, grads, state: GooState, params=None):
        """optax's form: the updates ``-lr · step`` (new tensors, in
        ``grads``' structure), the state advanced in place; the caller
        adds them to the parameters (``p + u``, as ``apply_updates``)."""
        lr_t = _lr_at(self.lr, state.count)
        names = _names(grads)
        if self.weight_decay != 0.0 and params is None:
            raise ValueError("goo with weight decay requires params")
        step = self._direction(params, grads, state, names)
        updates = torch._foreach_mul(step, -lr_t)
        if state.count is not None:
            state.count += 1
        return _restructure(updates, names)


class _GooAdam:
    def __init__(self, lr, b1, b2, eps, weight_decay):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    def _direction(self, params, grads, state: AdamState, names):
        """``m̂ / (sqrt(v̂) + eps)`` (``+ wd·p``), the moments advanced in
        place; returns ``(direction, lr, new count)``."""
        lr_t = _lr_at(self.lr, state.count)
        grads = _tensors(grads, names)
        mu, nu = _tensors(state.mu, names), _tensors(state.nu, names)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        # optax's bias corrections, 1 - decay**count, in float32.
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        update = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, _tensors(params, names), alpha=self.weight_decay)
        return update, lr_t, count

    @torch.no_grad()
    def step(self, params, grads, state: AdamState) -> AdamState:
        names = _names(params)
        update, lr_t, count = self._direction(params, grads, state, names)
        torch._foreach_add_(_tensors(params, names), update, alpha=-lr_t)
        state.count = count
        return state

    @torch.no_grad()
    def update(self, grads, state: AdamState, params=None):
        """optax's form: the updates ``-lr · direction`` (new tensors, in
        ``grads``' structure), the state advanced in place; the caller
        adds them to the parameters (``p + u``, as ``apply_updates``)."""
        if self.weight_decay and params is None:
            raise ValueError("goo_adam with weight decay requires params")
        names = _names(grads)
        update, lr_t, count = self._direction(params, grads, state, names)
        torch._foreach_mul_(update, -lr_t)
        state.count = count
        return _restructure(update, names)


def goo(
    lr: LearningRate,
    momentum: float = 0.0,
    *,
    nesterov: bool = False,
    weight_decay: float = 0.0,
    dampening: float = 0.0,
) -> _Goo:
    """Torch-``optim.sgd``-semantics SGD — the reference's goo update.
    Rejects what Torch rejects (Nesterov without momentum or with
    dampening). Buffers start at zero, so with dampening the first step
    differs from Torch's (as in the JAX package)."""
    return _Goo(lr, momentum, nesterov, weight_decay, dampening)


def goo_adam(
    lr: LearningRate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> _GooAdam:
    """Adam, or AdamW when ``weight_decay`` is non-zero, as optax computes
    them: ``u = m̂ / (sqrt(v̂) + eps)`` (+ ``wd·p``), ``p ← p − lr·u``."""
    return _GooAdam(lr, b1, b2, eps, weight_decay)


class _Elastic:
    # The ZeRO-1 wrapper hands this rule the ranks' flat replicas
    # (``replicas=``) beside its shards (opt/sharded.py).
    takes_replicas = True

    def __init__(self, alpha, beta, axis):
        self.alpha = alpha
        self.beta = alpha if beta is None else beta
        self.axis = axis

    def init(self, params) -> ElasticState:
        if isinstance(params, Mapping):
            return ElasticState(center={n: p.detach().clone() for n, p in params.items()})
        return ElasticState(center=[p.detach().clone() for p in params])

    def _mean(self, params, pulled, replicas, stacked):
        """x̄: the mean over the ranks of the post-step parameters, each
        element's sum in rank order over ``p``. ``replicas`` None: the
        rows of ``params`` are the ranks (``[p, N]``; one worker when
        ``axis`` is None). With ``replicas`` (the ranks' ``[p, N]`` flat
        parameters), ``params`` and ``pulled`` are ZeRO-1 ``[p, S]``
        shards, row ``r`` shard ``r`` of rank ``r``: shard ``r`` of x̄ is
        the sum over the ranks ``q`` of ``replicas[q]``'s shard ``r``
        plus ``pulled[r]`` (every rank adds the same gathered update), so
        element ``i`` is averaged with element ``i`` of every other
        replica, never with another shard's. Both forms add the same
        values in the same order: their centres are equal bit for bit.
        ``stacked`` False: one rank's own tensors (no rank dim)."""
        if replicas is None:
            if self.axis is None or not stacked:
                return params + pulled
            new = params + pulled
            acc = new[0].clone()
            for q in range(1, new.shape[0]):
                acc.add_(new[q])
            return acc / new.shape[0]
        p, s = params.shape
        flat = replicas
        if flat.shape[1] != p * s:
            flat = torch.nn.functional.pad(flat, (0, p * s - flat.shape[1]))
        x = flat.view(p, p, s)  # [rank q, shard r, S]
        acc = x[0] + pulled
        for q in range(1, p):
            acc.add_(x[q] + pulled)
        return acc / p

    @torch.no_grad()
    def update(self, updates, state: ElasticState, params=None, *, replicas=None,
               stacked=True):
        """``u − α·(p − c)`` (new tensors, in ``updates``' structure); the
        centre steps toward the ranks' mean of ``p + u − α·(p − c)``, in
        place. ``params`` and the centre are rank-stacked along ``axis``
        (dim 0), or ZeRO-1 shards with ``replicas`` (:meth:`_mean`);
        ``stacked`` False: one rank's tensors, the mean the rank itself."""
        if params is None:
            raise ValueError("elastic_average requires params")
        names = _names(updates)
        us, ps = _tensors(updates, names), _tensors(params, names)
        cs = _tensors(state.center, names)
        if replicas is not None and len(ps) != 1:
            raise ValueError("replicas= takes one flat shard buffer")
        pulled = []
        for u, p, c in zip(us, ps, cs):
            pull = u - torch.sub(p, c).mul_(self.alpha)
            mean = self._mean(p, pull, replicas, stacked)
            c.add_(torch.sub(mean, c).mul_(self.beta))
            pulled.append(pull)
        return _restructure(pulled, names)


class _Chain:
    def __init__(self, txs):
        self.txs = tuple(txs)
        self.takes_replicas = any(getattr(t, "takes_replicas", False) for t in self.txs)

    def __getattr__(self, name):
        # The base rule's settings (``lr``, ``momentum``) read through.
        if name == "txs":
            raise AttributeError(name)
        return getattr(self.txs[0], name)

    def init(self, params) -> tuple:
        return tuple(t.init(params) for t in self.txs)

    @torch.no_grad()
    def update(self, grads, state: tuple, params=None, *, replicas=None, stacked=True):
        """The updates through each rule in turn (optax's ``chain``);
        ``replicas`` and ``stacked`` go to the rules that take them."""
        updates = grads
        for t, st in zip(self.txs, state):
            if getattr(t, "takes_replicas", False):
                updates = t.update(updates, st, params, replicas=replicas, stacked=stacked)
            else:
                updates = t.update(updates, st, params)
        return updates

    @torch.no_grad()
    def step(self, params, grads, state: tuple) -> tuple:
        """One rank's step: ``p ← p + u`` (optax's ``apply_updates``)."""
        names = _names(params)
        grads = _restructure(_tensors(grads, names), names)  # keyed as the state is
        updates = self.update(grads, state, params, stacked=False)
        torch._foreach_add_(_tensors(params, names), _tensors(updates, names))
        return state


def elastic_average(
    alpha: float, beta: float | None = None, *, axis: str | None = None
) -> _Elastic:
    """The EASGD elastic term (``mpit_tpu.opt.goo.elastic_average``),
    chained after a base rule: ``chain(goo(lr), elastic_average(α,
    axis="data"))``. Worker: ``u ← u − α·(p − c)``; centre: ``c ← c +
    β·(x̄ − c)``, ``x̄`` the mean over ``axis``'s ranks of ``p + u``
    (``axis`` None: one worker, ``x̄ = p + u``); ``beta`` defaults to
    ``alpha``. On a World the ranks are the rows of the rank-stacked
    parameters; under ZeRO-1 each rank's centre shard averages that
    shard of every replica (:meth:`_Elastic._mean`)."""
    return _Elastic(alpha, beta, axis)


def chain(*txs) -> _Chain:
    """optax's ``chain`` of goo rules: ``init`` the tuple of their
    states, ``update`` the updates through each in turn, ``step`` one
    rank's ``p ← p + u``."""
    return _Chain(txs)
