"""Tensor-parallel training with FSDP: the port of :mod:`mpit_tpu.parallel.tp`.

The JAX package annotates each parameter with a ``PartitionSpec`` and
lets XLA's SPMD partitioner place the collectives (``pjit``). The port
keeps JAX's rules and specs, leaf for leaf, and lays each leaf out by
its spec over a single-controller World, the collectives placed by hand
(:mod:`mpit_tpu_torch.parallel.megatron` for the model axis):

- a spec is a tuple, one entry a dimension of the whole (JAX-shaped)
  leaf: an axis name or None; ``()`` is replicated (JAX's ``P()``);
- **the working layout**: a leaf cut on ``model`` is rank-stacked over
  the model ranks, ``[m, ...]`` with that dimension divided by ``m``; a
  leaf without ``model`` is held once. This is the tensor-parallel
  model's own parameter layout (the GPT-2's qkv columns repacked for
  the heads, its vocabulary padded to a multiple of ``m``:
  :func:`mpit_tpu_torch.serve.weights.shard_gpt2_params`);
- **the stored layout**: a leaf cut on the ``fsdp`` axis as well holds
  the fsdp ranks' shards stacked after the model ranks (``[m, f, ...]``,
  or ``[f, ...]``), that dimension divided by ``f``. The step gathers
  them in rank order before use
  (:func:`~mpit_tpu_torch.comm.collectives.gather_shards`) and
  reduce-scatters the gradient onto them
  (:func:`~mpit_tpu_torch.comm.collectives.scatter_sum`);
- the optimizer state follows its parameter: it is built on the stored
  leaves.

The batch splits over ``data``: each data rank's forward and backward
run in turn on the working parameters, and the gradients are summed over
the data ranks in rank order and divided by their number (JAX's global
mean); with no data axis the batch is replicated, as in JAX. A
replicated computation (the fsdp ranks' when ``fsdp`` is an axis of its
own) runs once.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping, Sequence

import torch

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.opt.sharded import _jax_key
from mpit_tpu_torch.train.step import TrainState

__all__ = [
    "fsdp_cut", "fsdp_gather", "fsdp_rules", "gpt2_tp_rules", "make_tp_train_step",
    "param_partition_specs", "specs_like_params",
]

Rules = Sequence[tuple[str, tuple]]


def _path(name: str) -> str:
    """A port parameter name as JAX's ``/``-joined tree path
    (``blocks.0.qkv.kernel`` → ``block_0/qkv/kernel``)."""
    return "/".join(_jax_key(str(name)))


def gpt2_tp_rules(axis: str = "model") -> Rules:
    """JAX's Megatron-pattern rules, keyed to its GPT-2 tree paths:
    ``qkv``/``fc`` column-parallel, ``proj``/``out`` row-parallel, ``wte``
    cut over the vocabulary; everything else replicated."""
    return [
        (r".*/qkv/kernel$", (None, axis)),
        (r".*/qkv/bias$", (axis,)),
        (r".*/fc/kernel$", (None, axis)),
        (r".*/fc/bias$", (axis,)),
        (r".*/proj/kernel$", (axis, None)),
        (r".*/out/kernel$", (axis, None)),
        (r".*wte$", (axis, None)),
    ]


def fsdp_rules(axis: str = "fsdp") -> Rules:
    """JAX's pure-FSDP rules: every matrix's first dimension."""
    return [(r".*kernel$", (axis,)), (r".*wte$", (axis,))]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _rule_spec(compiled, name: str) -> tuple:
    path = _path(name)
    return next((spec for pat, spec in compiled if pat.search(path)), ())


def param_partition_specs(
    params: Mapping,
    rules: Rules | None,
    *,
    fsdp_axis: str | None = None,
    fsdp_size: int | None = None,
) -> dict:
    """``{name: spec}`` for ``params`` (name → tensor or shape, the whole
    leaves): the first rule whose pattern matches the leaf's JAX path
    wins, none is replicated. With ``fsdp_axis``, the first dimension
    no rule assigned that ``fsdp_size`` divides (and is not below) is
    cut over it too, and every spec has one entry a dimension (JAX's
    ``P(*entries)``)."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in (rules or [])]
    out = {}
    for name, leaf in params.items():
        spec = _rule_spec(compiled, name)
        if fsdp_axis is not None:
            shape = _shape(leaf)
            size = fsdp_size or 1
            entries = list(spec) + [None] * (len(shape) - len(spec))
            for d, n in enumerate(shape):
                if entries[d] is None and n % size == 0 and n >= size:
                    entries[d] = fsdp_axis
                    break
            spec = tuple(entries)
        out[name] = spec
    return out


def specs_like_params(state, params: Mapping, param_specs: Mapping):
    """Specs for an optimizer state (a goo state dataclass, or a chain's
    tuple of them): a mapping keyed like ``params`` whose leaves have
    their shapes (the moments) takes their specs, everything else (the
    counts) is replicated. Returns the state's structure: a dataclass as
    ``{field: specs}``, a tuple as a tuple, a mapping as ``{name: spec}``."""
    if isinstance(state, tuple):
        return tuple(specs_like_params(s, params, param_specs) for s in state)
    if isinstance(state, Mapping):
        return {
            name: param_specs[name]
            if name in params and _shape(leaf) == _shape(params[name]) else ()
            for name, leaf in state.items()
        }
    if hasattr(state, "__dataclass_fields__"):
        return {f: specs_like_params(getattr(state, f), params, param_specs)
                for f in state.__dataclass_fields__}
    return ()


def _dim(spec: tuple, axis: str | None):
    return spec.index(axis) if axis is not None and axis in spec else None


def fsdp_cut(t, spec: tuple, f: int, *, fsdp_axis: str, model_axis: str = "model"):
    """A working-layout leaf cut over the fsdp ranks by its spec: the
    ``f`` shards stacked after the model ranks (as they are, when the
    spec has no fsdp entry)."""
    d = _dim(spec, fsdp_axis)
    if d is None:
        return t
    stacked = _dim(spec, model_axis) is not None
    work_dim = d + stacked
    if t.shape[work_dim] % f:
        raise ValueError(f"dim {d} ({t.shape[work_dim]}) is not divisible by the {f} fsdp ranks")
    return torch.stack(t.chunk(f, dim=work_dim), dim=int(stacked))


def fsdp_gather(t, spec: tuple, *, fsdp_axis: str, model_axis: str = "model"):
    """Inverse of :func:`fsdp_cut`: the fsdp shards joined in rank order
    (:func:`~mpit_tpu_torch.comm.collectives.gather_shards`)."""
    d = _dim(spec, fsdp_axis)
    if d is None:
        return t
    stacked = _dim(spec, model_axis) is not None
    return C.gather_shards(t, rank_dim=int(stacked), dim=d + stacked)


def _whole_shape(name: str, t, compiled, m: int, model_axis: str) -> tuple:
    """The whole leaf's shape of a working-layout tensor: a leaf its rule
    cuts on ``model`` is ``[m, ...]``, that dimension ``m`` times longer
    whole."""
    d = _dim(_rule_spec(compiled, name), model_axis)
    if d is None:
        return tuple(t.shape)
    shape = list(t.shape[1:])
    shape[d] *= m
    return tuple(shape)


def make_tp_train_step(
    loss_fn: Callable,
    tx,
    world,
    rules: Rules | None,
    *,
    data_axis: str = "data",
    fsdp_axis: str | None = None,
    model_axis: str = "model",
):
    """``(init_fn, step_fn, specs_fn)``: data parallelism over
    ``data_axis``, tensor parallelism as the model's working layout lays
    it out, FSDP over ``fsdp_axis`` (module docstring). The counterpart of
    JAX's ``make_pjit_train_step``.

    ``loss_fn(params, batch) -> (loss, aux)`` reads the working
    parameters (the tensor-parallel model's own, which ``params`` are).
    ``specs_fn(params)``: ``{name: spec}`` of working-layout parameters,
    from their whole shapes (JAX's ``param_partition_specs``).
    ``init_fn(params)``: the model's parameters (working layout) →
    :class:`~mpit_tpu_torch.train.step.TrainState` whose ``params`` are
    the stored leaves (the working tensors themselves without FSDP) and
    ``opt_state`` ``tx.init`` of them. ``step_fn(state, batch) -> (state,
    metrics)``: ``batch`` the global batch (leading dim split over the
    data ranks); gathers the fsdp shards into the working parameters,
    steps in place, never waits on the device. ``step_fn.gather(state)``
    refreshes the working parameters from the stored ones (after a
    restore or at the end of a run)."""
    if fsdp_axis is not None and fsdp_axis not in world.shape:
        raise ValueError(f"fsdp axis {fsdp_axis!r} is not an axis of {dict(world.shape)}")
    m, d = world.size(model_axis), world.size(data_axis)
    f = world.size(fsdp_axis) if fsdp_axis else 1
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in (rules or [])]
    work: dict = {}
    specs: dict = {}

    def specs_fn(params):
        shapes = {n: _whole_shape(n, t, compiled, m, model_axis) for n, t in params.items()}
        return param_partition_specs(shapes, rules, fsdp_axis=fsdp_axis, fsdp_size=f)

    def cut(name, t):
        return fsdp_cut(t, specs[name], f, fsdp_axis=fsdp_axis, model_axis=model_axis)

    def init_fn(params) -> TrainState:
        work.clear()
        work.update(params)
        specs.clear()
        specs.update(specs_fn(work))
        if fsdp_axis is None:
            stored = dict(work)
        else:
            with torch.no_grad():
                stored = {n: cut(n, t.detach()).clone() for n, t in work.items()}
        return TrainState(step=0, params=stored, opt_state=tx.init(stored))

    @torch.no_grad()
    def gather(state) -> None:
        if fsdp_axis is None:
            return
        for n, t in work.items():
            t.copy_(fsdp_gather(state.params[n], specs[n], fsdp_axis=fsdp_axis,
                                model_axis=model_axis))

    def step_fn(state: TrainState, batch):
        gather(state)
        parts = shard_batch(world, batch, axis=data_axis)
        names = list(work)
        leaves = [work[n] for n in names]
        per_rank, losses, auxes = [], [], []
        for part in parts:
            loss, aux = loss_fn(work, part)
            per_rank.append(torch.autograd.grad(loss, leaves, materialize_grads=True))
            losses.append(loss.detach())
            auxes.append(aux)
        grads = {}
        with torch.no_grad():
            for j, n in enumerate(names):
                terms = [g[j] for g in per_rank]
                dim = _dim(specs[n], fsdp_axis)
                if dim is not None:  # the sum over the data ranks, cut over fsdp
                    stacked = _dim(specs[n], model_axis) is not None
                    g = C.scatter_sum(terms, f, rank_dim=int(stacked), dim=dim + stacked)
                else:
                    g = terms[0]
                    for t in terms[1:]:
                        g = g + t
                grads[n] = g / d if d > 1 else g
            tx.step(state.params, grads, state.opt_state)
        state.step += 1
        metrics = {"loss": sum(losses) / d}
        for key in auxes[0]:
            metrics[key] = sum(a[key] for a in auxes) / d
        return state, metrics

    step_fn.gather = gather
    step_fn.grad_sync_mode = "psum"
    return init_fn, step_fn, specs_fn
