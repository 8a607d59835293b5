"""Context-parallel training: GPT-2 with the sequence cut over the ``seq``
ranks, the port of :mod:`mpit_tpu.parallel.cp`.

Each data rank's ``[B/d, T]`` tokens are cut into the seq ranks'
``[B/d, T/S]`` shards, rank-stacked ``[S, B/d, T/S]``. The model runs
over the stacked shards with the rank dimension as a leading batch
dimension (``[S·B/d, T/S]`` rows): everything but attention is
position-local, and the model's ``attention_fn`` sees every rank's K/V
at once, as the stack (:func:`make_seq_attention`). The two places the
cut bites, as in JAX:

- **positions**: shard ``s`` embeds global positions ``s·T/S + arange(T/S)``
  (:meth:`~mpit_tpu_torch.models.gpt2.GPT2.forward`'s ``positions``);
- **targets across the cut**: a shard's last target is the right
  neighbour's first token (:func:`~mpit_tpu_torch.comm.collectives.shift`
  by -1), and the global last position has none (masked); the loss is
  the masked sum over the global count of targets, so summed over the
  ranks it is the exact global mean.

The gradients' sum over ``seq`` rides the batched backward (the seq
ranks' rows are one batch of every weight's product). Over ``data``:
ZeRO-1 through :mod:`mpit_tpu_torch.opt.sharded` with ``mean_grads=False``
semantics (the loss is already globally normalised), or with ``zero1``
False the sum over the data ranks; one model per data rank, as the
data-parallel step holds them (:func:`mpit_tpu_torch.train.make_train_step`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.comm import init as init_world
from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mpit_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from mpit_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from mpit_tpu_torch.parallel.ulysses import ulysses_attention
from mpit_tpu_torch.train.step import make_train_step

__all__ = ["make_gpt2_cp_train_step", "make_seq_attention"]


def make_seq_attention(seq_ranks: int, *, flash: bool = False, ulysses: bool = False):
    """The sequence-sharded attention of the CP tier, as a model's
    ``attention_fn``: it takes the model's ``[S·B, T/S, H, D]`` rows
    (rank-major), runs the ring (:func:`ring_attention`), the flash
    ring (:func:`ring_flash_attention`, with ``flash``) or Ulysses
    (:func:`ulysses_attention`, with ``ulysses``; the flash kernels as
    its inner attention with ``flash``, else the plain
    :func:`reference_attention`) over the ``[S, B, T/S, H, D]`` stack,
    and returns the rows."""
    if ulysses:
        attn = partial(ulysses_attention,
                       inner=flash_attention if flash else reference_attention)
    else:
        attn = ring_flash_attention if flash else ring_attention

    def attention_fn(q, k, v, *, causal: bool = True):
        stack = lambda x: x.view(seq_ranks, -1, *x.shape[1:])  # noqa: E731
        return attn(stack(q), stack(k), stack(v), causal=causal).reshape(q.shape)

    return attention_fn


def _cp_loss(model: GPT2, tokens, count: float):
    """A data rank's share of the global mean loss: ``tokens`` ``[S, b,
    T/S]``, every shard's masked per-token losses summed over ``count``,
    the global number of targets."""
    s_ranks, b, tl = tokens.shape
    dev = tokens.device
    positions = torch.arange(s_ranks, device=dev)[:, None] * tl + torch.arange(tl, device=dev)
    next_first = C.shift(tokens[:, :, :1], -1)  # the right neighbour's first token
    targets = torch.cat((tokens[:, :, 1:], next_first), dim=2)
    mask = torch.ones((s_ranks, 1, tl), device=dev)
    mask[-1, :, -1] = 0.0  # the global last position has no target
    rows = lambda x: x.reshape(s_ranks * b, tl)  # noqa: E731
    losses = model(rows(tokens), positions=rows(positions[:, None].expand(s_ranks, b, tl)),
                   targets=rows(targets))
    return (losses.view(s_ranks, b, tl) * mask).sum() / count


def make_gpt2_cp_train_step(
    cfg: GPT2Config,
    tx,
    world,
    *,
    data_axis: str = "data",
    seq_axis: str = "seq",
    zero1: bool = True,
    flash: bool = False,
    ulysses: bool = False,
):
    """``(init_fn, step_fn, state_specs)`` for sequence-sharded GPT-2
    over ``world``'s data and seq ranks, on its one device.

    ``init_fn(params)``: a one-rank GPT-2 ``state_dict``, loaded into
    each data rank's model (``step_fn.models``; their ``attention_fn``
    :func:`make_seq_attention`'s). ``step_fn(state, batch)``: ``batch``
    the global ``{"tokens": [B, T]}`` (T divisible by S and above it),
    cut over ``(data, seq)`` (:func:`~mpit_tpu_torch.data.shard_batch`
    with ``seq_axis``); ``metrics["loss"]`` the global mean, a device
    scalar. ``state_specs(params)``: each parameter replicated (``()``),
    the optimizer state cut over ``data_axis`` under ZeRO-1."""
    n_seq = world.axis_size(seq_axis)
    n_data = world.size(data_axis)
    device = world.device
    mcfg = dataclasses.replace(
        cfg, attention_fn=make_seq_attention(n_seq, flash=flash, ulysses=ulysses)
    )
    models = [GPT2(mcfg, device=device) for _ in range(n_data)]
    loss_fns = [
        (lambda m: lambda params, batch: (_cp_loss(m, batch["tokens"].long(), batch["count"]), {}))(m)
        for m in models
    ]
    dworld = init_world({data_axis: n_data}, devices=[device]) if n_data > 1 else None
    inner_init, inner_step = make_train_step(
        loss_fns if dworld else loss_fns[0], tx, dworld, zero1=zero1, mean_grads=False
    )

    def init_fn(params):
        for m in models:
            m.load_state_dict(params)
        ranks = [dict(m.named_parameters()) for m in models]
        return inner_init(ranks if dworld else ranks[0])

    def step_fn(state, batch):
        tokens = batch["tokens"]
        t = tokens.shape[1]
        if t % n_seq or t <= n_seq:
            raise ValueError(f"T ({t}) must divide by the seq axis size ({n_seq}) and exceed it")
        parts = shard_batch(world, {"tokens": tokens}, axis=data_axis, seq_axis=seq_axis)
        count = float(tokens.shape[0] * (t - 1))  # every row's targets but the last position's
        for part in parts:
            part["count"] = count
        return inner_step(state, parts if dworld else parts[0])

    def state_specs(params):
        return {"params": {name: () for name in params},
                "opt_state": (data_axis,) if zero1 and dworld else ()}

    step_fn.models = models
    step_fn.grad_sync_mode = inner_step.grad_sync_mode
    return init_fn, step_fn, state_specs
