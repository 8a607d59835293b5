"""The training step: value and grad on every rank, the gradient sync,
then the optimizer update. The port of :mod:`mpit_tpu.train.step`.

JAX's step is one jitted SPMD function over the mesh that rebuilds the
state; here the step runs eagerly and updates parameters and optimizer
state IN PLACE under ``torch.no_grad()``.

- **One rank** (``world`` None): the JAX step's collectives are
  identities (``pmean`` over one device) and its ZeRO-1 shard is the
  whole state, so the goo rule steps the model's parameters directly.
- **A World of p ranks**: the single controller runs every rank's
  forward and backward in turn (rank ``r`` on its model, on its slice of
  the batch), then syncs the gradients and updates every replica:

  - each rank's parameters are views into row ``r`` of one ``[p, N]``
    flat buffer in the JAX package's flat layout
    (:class:`~mpit_tpu_torch.opt.sharded.FlatLayout`), so the flat
    parameters cost nothing and one add applies every rank's update;
  - each rank's gradients are copied into row ``r`` of a ``[p, N]``
    buffer (the pads stay zero);
  - ZeRO-1 (``zero1``): reduce-scatter, the goo rule on the ``[p, S]``
    shards, all-gather of the updates (not the parameters: an int8
    gather of quantized parameters would be another result), through
    :class:`~mpit_tpu_torch.train.grad_sync.GradSync`; plain DP: the
    mean allreduce, then the rule on ``[p, N]`` replicated state;
  - every rank adds the same gathered updates to the same parameters, so
    the replicas stay bit-identical (:meth:`TrainState.replicas_equal`).

  Metrics are the mean over the ranks, summed in rank order.

- **Stateful** (``stateful=True``, the ResNet's BatchNorm): the loss also
  takes and returns the model state that is not a gradient (``extra``,
  the norms' running averages). On p ranks every rank's new state is
  averaged over the ranks, summed in rank order (JAX's ``pmean``), and
  every rank's buffers are set to that mean, so the replicas stay
  bit-identical; on one rank the new state is kept as it is. The state
  is no parameter: it stays out of the flat buffers and of ZeRO-1.

:func:`make_eval_step` is the eval counterpart: ``eval_fn`` on every
rank's slice of the batch, its metrics combined over the ranks in rank
order (the exact-count contract of JAX's ``make_eval_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len, sharded
from mpit_tpu_torch.train.grad_sync import GRAD_SYNC_MODES, GradSync

__all__ = ["FlatReplicas", "TrainState", "make_eval_step", "make_train_step"]


class FlatReplicas:
    """The ranks' parameters as views into rows of one ``[p, N]`` buffer
    (``params``) and their gradients' ``[p, N]`` buffer (``grads``), ``N``
    the flat length padded to a multiple of ``p·128``. Building it
    rebinds every given parameter's ``.data`` to its view; the values
    are copied over first."""

    def __init__(self, params_list: Sequence[Mapping[str, torch.Tensor]]):
        p = len(params_list)
        self.layout = FlatLayout(params_list[0])
        first = params_list[0][self.layout.names[0]]
        n = padded_len(self.layout.total, p)
        self.params = torch.zeros((p, n), dtype=first.dtype, device=first.device)
        self.grads = torch.zeros_like(self.params)
        self.leaves, self.grad_views = [], []
        for r, params in enumerate(params_list):
            if set(params) != set(self.layout.names):
                raise ValueError(f"rank {r}'s parameters are not rank 0's")
            views = self.layout.views(self.params[r])
            with torch.no_grad():
                for name in self.layout.names:
                    t = params[name]
                    if t.dtype != first.dtype or t.device != first.device:
                        raise ValueError(
                            f"rank {r}'s {name} is {t.dtype} on {t.device}; every "
                            f"parameter must be {first.dtype} on {first.device}"
                        )
                    views[name].copy_(t)
                    t.data = views[name]
            self.leaves.append([params[n] for n in self.layout.names])
            gviews = self.layout.views(self.grads[r])
            self.grad_views.append([gviews[n] for n in self.layout.names])


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and step counter.

    One rank: ``params`` maps names (the model's ``state_dict`` names) to
    tensors; once bound (:meth:`bind`) they are the model's own
    parameters, so the in-place update is the model's update. A World of
    ``p`` ranks: ``params`` is the list of the ranks' mappings, ``flat``
    their :class:`FlatReplicas`, and the optimizer state's buffers are
    rank-stacked ``[p, S]`` shards (ZeRO-1) or ``[p, N]`` replicas.
    ``step`` is a host int. ``extra`` is the model state that is not a
    gradient (JAX's ``extra``: the BatchNorm buffers of a stateful step),
    a name → tensor mapping, or with p ranks a list of one per rank;
    None for a stateless model."""

    step: int
    params: Any
    opt_state: Any
    flat: FlatReplicas | None = None
    extra: Any = None

    def bind(self, model) -> "TrainState":
        """Load ``params`` into ``model`` (a list of models, one per rank,
        for a p-rank state) and return the state holding the models' own
        parameter tensors, the optimizer state on their device."""
        if isinstance(self.params, Mapping):
            model.load_state_dict(self.params, strict=True)
            return dataclasses.replace(self, params=dict(model.named_parameters()))
        if len(model) != len(self.params):
            raise ValueError(f"{len(model)} models for a {len(self.params)}-rank state")
        for m, params in zip(model, self.params):
            m.load_state_dict(params, strict=True)
        params = [dict(m.named_parameters()) for m in model]
        flat = FlatReplicas(params)
        device = flat.params.device
        opt = _map_tensors(self.opt_state, lambda t: t.to(device))
        return dataclasses.replace(self, params=params, opt_state=opt, flat=flat)

    def replicas_equal(self) -> bool:
        """Whether every rank's parameters, and its ``extra`` buffers,
        equal rank 0's bit for bit."""
        if self.flat is None:
            return True
        rows = self.flat.params
        if not all(torch.equal(rows[0], rows[r]) for r in range(1, rows.shape[0])):
            return False
        extra = self.extra or [{}]
        return all(torch.equal(extra[0][k], t) for e in extra[1:] for k, t in e.items())


def _map_tensors(state, fn):
    """``state`` (a goo state dataclass, or a chain's tuple of them) with
    ``fn`` applied to every tensor of its buffer lists."""
    if isinstance(state, tuple):
        return tuple(_map_tensors(s, fn) for s in state)
    if not dataclasses.is_dataclass(state):
        return state
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, list):
            v = [fn(t) for t in v]
        elif isinstance(v, torch.Tensor):
            v = fn(v)
        out[f.name] = v
    return dataclasses.replace(state, **out)


def make_train_step(
    loss_fn,
    tx,
    world=None,
    *,
    zero1: bool = True,
    stateful: bool = False,
    grad_sync: str = "psum",
    grad_bucket_mb: float = 4.0,
    mean_grads: bool = True,
):
    """Build ``(init_fn, step_fn)`` for training on one rank (``world``
    None) or over a :class:`~mpit_tpu_torch.comm.World`'s ranks.

    ``loss_fn(params, batch) -> (loss, aux)``, or a list of one per rank:
    ``params`` is a rank's name → tensor mapping; a model-backed loss
    reads them through the model they are bound to. With ``stateful``,
    ``loss_fn(params, extra, batch) -> (loss, aux, new_extra)``: ``extra``
    the rank's state that is not a gradient (name → tensor, e.g. a
    model's BatchNorm buffers), ``new_extra`` its next value (it may be
    ``extra`` itself, updated in place). ``tx`` is a goo rule
    (:mod:`mpit_tpu_torch.opt.goo`). ``grad_sync``: ``psum`` | ``ring``
    | ``ring_q8``, in ``grad_bucket_mb`` buckets (a World of one rank
    syncs nothing). ``mean_grads`` False: the ranks' gradients and
    losses are summed, not averaged (JAX's ``sharded(...,
    mean_grads=False)``, for a loss each rank already divides by the
    global count, as the context-parallel step's does).

    ``init_fn(params, extra=None) -> TrainState``: one mapping (one rank)
    or a list of one per rank, the ranks' parameters rebound into one
    flat buffer; ``extra`` likewise (the step writes its new values into
    these tensors).
    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` one mapping
    (one rank) or a list of one per rank
    (:func:`mpit_tpu_torch.data.shard_batch`); ``metrics["loss"]`` a
    detached device scalar: the step never waits on the device.
    ``step_fn.grad_sync_mode`` names what the sync runs
    (:attr:`GradSync.exec_mode`; ``none`` on one rank)."""
    if grad_sync not in GRAD_SYNC_MODES:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, got {grad_sync!r}")
    if world is None:
        return _one_rank(loss_fn, tx, stateful)
    return _ranks(loss_fn, tx, world, zero1, stateful,
                  GradSync(world, grad_sync, bucket_mb=grad_bucket_mb), mean_grads)


def _call_loss(loss_fn, params, extra, batch, stateful: bool):
    """``(loss, aux, new_extra)`` of either loss form (``new_extra`` None
    without ``stateful``)."""
    if stateful:
        return loss_fn(params, extra, batch)
    return (*loss_fn(params, batch), None)


def _set_extra(dst: Mapping, new: Mapping) -> None:
    """Write ``new`` into the state's ``extra`` tensors (a no-op where
    ``new`` is ``dst`` itself)."""
    if set(new) != set(dst):
        raise ValueError(f"new_extra names {sorted(set(new) ^ set(dst))} differ from extra's")
    with torch.no_grad():
        for k, t in dst.items():
            if new[k] is not t:
                t.copy_(new[k])


def _one_rank(loss_fn, tx, stateful: bool):
    def init_fn(params, extra=None) -> TrainState:
        return TrainState(step=0, params=dict(params), opt_state=tx.init(dict(params)),
                          extra=None if extra is None else dict(extra))

    def step_fn(state: TrainState, batch):
        params = state.params
        loss, aux, new_extra = _call_loss(loss_fn, params, state.extra, batch, stateful)
        grads = torch.autograd.grad(loss, list(params.values()))
        if stateful:  # after the backward, which may read the old state
            _set_extra(state.extra, new_extra)
        tx.step(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), **aux}

    step_fn.grad_sync_mode = "none"
    return init_fn, step_fn


def _ranks(loss_fn, tx, world, zero1: bool, stateful: bool, gs: GradSync,
           mean_grads: bool = True):
    p = world.num_devices
    loss_fns = list(loss_fn) if isinstance(loss_fn, (list, tuple)) else [loss_fn] * p
    if len(loss_fns) != p:
        raise ValueError(f"{len(loss_fns)} loss functions for {p} ranks")
    stx = sharded(tx, world, mean_grads=mean_grads, comm=gs) if zero1 else None

    def init_fn(params_list, extra=None) -> TrainState:
        if len(params_list) != p:
            raise ValueError(f"{len(params_list)} parameter sets for {p} ranks")
        if extra is not None and len(extra) != p:
            raise ValueError(f"{len(extra)} extra states for {p} ranks")
        flat = FlatReplicas(params_list)
        if flat.params.device != world.device:
            raise ValueError(f"parameters on {flat.params.device}, the World on {world.device}")
        opt = stx.init(flat.params) if zero1 else tx.init([flat.params.clone()])
        return TrainState(step=0, params=list(params_list), opt_state=opt, flat=flat,
                          extra=None if extra is None else [dict(e) for e in extra])

    def step_fn(state: TrainState, batches: Sequence):
        if len(batches) != p:
            raise ValueError(f"{len(batches)} batches for {p} ranks")
        flat = state.flat
        losses, auxes, new_extras = [], [], []
        for r in range(p):
            extra = None if state.extra is None else state.extra[r]
            loss, aux, new_extra = _call_loss(loss_fns[r], state.params[r], extra, batches[r],
                                              stateful)
            grads = torch.autograd.grad(loss, flat.leaves[r], materialize_grads=True)
            torch._foreach_copy_(flat.grad_views[r], grads)
            losses.append(loss.detach())
            auxes.append(aux)
            new_extras.append(new_extra)
        if stateful:
            _average_extra(state.extra, new_extras)
        with torch.no_grad():
            if zero1:
                updates = stx.update(flat.grads, state.opt_state, flat.params)
            else:
                (updates,) = tx.update([gs.allreduce_grads(flat.grads, mean=mean_grads)],
                                       state.opt_state, [flat.params])
            flat.params[:, : updates.shape[1]].add_(updates)
        state.step += 1
        n = p if mean_grads else 1
        metrics = {"loss": sum(losses) / n}
        for key in auxes[0]:
            metrics[key] = sum(a[key] for a in auxes) / n
        return state, metrics

    step_fn.grad_sync_mode = gs.exec_mode
    step_fn.grad_sync = gs
    return init_fn, step_fn


@torch.no_grad()
def _average_extra(extras: Sequence[Mapping], new_extras: Sequence[Mapping]) -> None:
    """JAX's ``pmean`` of the ranks' new state: each tensor's sum over
    the ranks in rank order, over ``p``, written into every rank's
    ``extra`` (the means are taken before any rank's tensors are
    written, so ``new_extras`` may be ``extras`` themselves)."""
    p = len(extras)
    names = list(extras[0])
    for r, new in enumerate(new_extras):
        if set(new) != set(names):
            raise ValueError(f"rank {r}'s new_extra names differ from its extra's")
    means = [new_extras[0][k].clone() for k in names]
    for new in new_extras[1:]:
        torch._foreach_add_(means, [new[k] for k in names])
    torch._foreach_div_(means, float(p))
    for extra in extras:
        torch._foreach_copy_([extra[k] for k in names], means)


def make_eval_step(eval_fn, world=None, *, stateful: bool = False):
    """Build ``eval_step(state, batch) -> metrics`` on one rank (``world``
    None) or over a World's ranks: the port of JAX's ``make_eval_step``.

    ``eval_fn(params, batch) -> metrics`` (scalar tensors), or a list of
    one per rank (with ``stateful``, ``eval_fn(params, extra, batch)``,
    ``extra`` the rank's :attr:`TrainState.extra`: the running
    statistics a BatchNorm model normalises with); it runs under
    ``torch.no_grad()`` on each rank's parameters and slice of the batch
    (one mapping on one rank, a list of one per rank otherwise), and the
    ranks' metrics are combined in rank order. Exact-count contract: where ``eval_fn`` returns a
    ``"_weight"`` (its count of real, unpadded rows), every other metric
    is a weighted mean, combined as ``Σ m·w / max(Σ w, 1)``, and the
    result's ``"_weight"`` is ``Σ w``; without one, the plain mean over
    the ranks."""
    p = 1 if world is None else world.num_devices
    eval_fns = list(eval_fn) if isinstance(eval_fn, (list, tuple)) else [eval_fn] * p
    if len(eval_fns) != p:
        raise ValueError(f"{len(eval_fns)} eval functions for {p} ranks")

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        params = [state.params] if world is None else state.params
        extras = [state.extra] if world is None else state.extra
        batches = [batch] if world is None else batch
        if len(batches) != p:
            raise ValueError(f"{len(batches)} batches for {p} ranks")
        ranks = [dict(eval_fns[r](params[r], extras[r], batches[r]) if stateful
                      else eval_fns[r](params[r], batches[r])) for r in range(p)]
        weights = [m.pop("_weight", None) for m in ranks]
        if weights[0] is None:
            return {k: sum(m[k] for m in ranks) / p for k in ranks[0]}
        wsum = sum(weights)
        out = {k: sum(m[k] * w for m, w in zip(ranks, weights)) / wsum.clamp_min(1.0)
               for k in ranks[0]}
        out["_weight"] = wsum
        return out

    return eval_step
