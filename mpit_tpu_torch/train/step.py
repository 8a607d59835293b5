"""The training step on one rank: value and grad, then the optimizer
update.

The port of :mod:`mpit_tpu.train.step` for a single rank. JAX's step is
one jitted SPMD function over the mesh that rebuilds the state; here
the step runs eagerly and updates the parameters and optimizer state IN
PLACE under ``torch.no_grad()``. On one rank the JAX step's collectives
are identities (``pmean`` over one device) and its ZeRO-1 shard is the
whole state, so ``zero1`` changes nothing here. More than one rank, and
the ring gradient-sync tiers, arrive with the collectives slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["TrainState", "make_train_step"]

_COLLECTIVES_SLICE = "the ring-collectives slice (slice 8 of the port, 4 chips)"


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and step counter.

    ``params`` maps names (the model's ``state_dict`` names) to tensors;
    once bound (:meth:`bind`) they are the model's own parameters, so
    the in-place update is the model's update. ``step`` is a host int.
    (JAX's ``extra``, non-gradient model state such as BatchNorm
    statistics, comes with the convnet slice.)"""

    step: int
    params: dict
    opt_state: Any

    def bind(self, model: torch.nn.Module) -> "TrainState":
        """Load ``params`` into ``model`` and return the state holding the
        model's own parameter tensors (same names, same optimizer state)."""
        model.load_state_dict(self.params, strict=True)
        return dataclasses.replace(self, params=dict(model.named_parameters()))


def make_train_step(
    loss_fn: Callable,
    tx,
    *,
    world_size: int = 1,
    zero1: bool = True,
    grad_sync: str = "psum",
):
    """Build ``(init_fn, step_fn)`` for training on one rank.

    ``loss_fn(params, batch) -> (loss, aux)``: ``params`` is the state's
    name → tensor mapping; a model-backed loss reads them through the
    model they are bound to. ``tx`` is a goo rule
    (:mod:`mpit_tpu_torch.opt.goo`).

    ``init_fn(params) -> TrainState`` (step 0, ``tx.init``);
    ``step_fn(state, batch) -> (state, metrics)`` with ``metrics["loss"]``
    a detached device scalar: the step never waits on the device."""
    if world_size != 1:
        raise SystemExit(
            f"{world_size} ranks: data parallelism and ZeRO-1 over more than "
            f"one rank arrive with {_COLLECTIVES_SLICE}"
        )
    if grad_sync != "psum":
        raise SystemExit(
            f"--grad-sync {grad_sync}: the ring tiers arrive with {_COLLECTIVES_SLICE}"
        )
    del zero1  # one rank: the shard is the whole state

    def init_fn(params) -> TrainState:
        return TrainState(step=0, params=dict(params), opt_state=tx.init(dict(params)))

    def step_fn(state: TrainState, batch):
        params = state.params
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), **aux}

    return init_fn, step_fn
