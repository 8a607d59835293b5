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

A learning rate is a constant or a schedule ``count -> lr``
(:mod:`mpit_tpu_torch.opt.schedules`), called with the count before the
step increments it. Counts are host integers: a schedule never waits on
the device. ``elastic_average`` comes with the elastic-averaging slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpit_tpu_torch.opt.schedules import LearningRate

__all__ = ["AdamState", "GooState", "goo", "goo_adam"]


@dataclasses.dataclass
class GooState:
    """Momentum buffers (None without momentum) and the schedule count
    (None for a constant lr)."""

    momentum: list | None
    count: int | None = None


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
