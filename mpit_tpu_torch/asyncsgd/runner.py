"""Shared run harness of the port's training workloads: the SPMD subset
of :mod:`mpit_tpu.asyncsgd.runner`.

:func:`run_spmd` drives the train step (value and grad, gradient sync,
goo update) for ``cfg.steps`` steps through
:func:`mpit_tpu_torch.train.hardened_loop`: on one rank, or with
``--mesh data=N`` over a :class:`~mpit_tpu_torch.comm.World` of ``N``
ranks (ZeRO-1 with ``--zero1``, the sync by ``--grad-sync`` in
``--grad-bucket-mb`` buckets), the global batch split over them.
Everything of the JAX harness that needs a checkpoint directory or a
later slice's machinery is refused with ``SystemExit`` naming the slice
that brings it: the flags of :data:`LATER_FLAGS` (not fields of the
port's config, so nothing can read them by mistake) as the command line
is parsed, and the values of ``--mode`` and ``--mesh`` that this slice
does not run by :func:`reject_later_slices`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mpit_tpu_torch.asyncsgd.config import TrainConfig
from mpit_tpu_torch.comm import init as init_world
from mpit_tpu_torch.serve.engine import resolve_device
from mpit_tpu_torch.train import MetricLogger, hardened_loop, make_train_step

__all__ = [
    "LATER_FLAGS", "describe", "make_stream", "make_world", "reject_later_slices", "run_spmd",
]

_WORKLOADS = "the convnet-training slice (MNIST, ImageNet, ResNet)"
_CHECKPOINT = "the checkpoint slice of the port"
_OBSERVABILITY = "the observability slice of the port"
_DATA = "the data-pipeline slice of the port"
_EASGD = "the elastic-averaging slice of the port"

# The JAX TrainConfig's flags that no code of this slice reads -> the
# slice that brings them. Giving one raises SystemExit naming it.
LATER_FLAGS = {
    "momentum": _WORKLOADS,  # the goo SGD workloads; gpt2 trains with goo_adam
    **dict.fromkeys(
        ("easgd", "easgd_alpha", "easgd_beta", "sync_every", "nranks", "lease_s",
         "heartbeat_s", "staleness_bound"),
        _EASGD,
    ),
    # The port's prefetch has one thread and a fixed depth.
    **dict.fromkeys(("native", "data_dir", "prefetch_workers", "prefetch_max_depth"), _DATA),
    **dict.fromkeys(
        ("ckpt_dir", "ckpt_every", "save_dense", "resume_dense", "max_restores"), _CHECKPOINT
    ),
    **dict.fromkeys(("profile_dir", "sentinel"), _OBSERVABILITY),
    **dict.fromkeys(
        ("eval_batch", "eval_every", "eval_batches", "augment", "augment_mode", "crop_pad",
         "train_size", "rrc_min_scale"),
        _WORKLOADS,
    ),
}


def reject_later_slices(cfg: TrainConfig) -> None:
    """``SystemExit`` for the values of the config's fields that this
    slice does not run: a mode other than ``spmd`` and a mesh axis other
    than ``data``."""
    if cfg.mode != "spmd":
        raise SystemExit(
            f"--mode {cfg.mode}: the parity and elastic tiers arrive with {_EASGD}"
        )
    mesh = cfg.mesh_shape() or {}
    if set(mesh) - {"data"}:
        raise SystemExit(
            f"--mesh {cfg.mesh}: the model/seq/pipe/expert tiers arrive with "
            "the tensor-parallel slice and the parallel tiers after it"
        )


def make_world(cfg: TrainConfig, device):
    """The World of ``--mesh data=N`` ranks on ``device`` (every CUDA
    device for a bare ``cuda``; ranks over more than one raise), or None
    for one rank."""
    p = (cfg.mesh_shape() or {}).get("data", 1)
    if p == 1:
        return None
    device = torch.device(device)
    devices = None if device.type == "cuda" and device.index is None else [device]
    world = init_world({"data": p}, devices=devices)
    world.device  # noqa: B018 -- raises for ranks over several devices
    return world


def make_stream(cfg: TrainConfig, dataset, *args, skip: int = 0):
    """The workload's input stream: the dataset's Python generator
    (``--native``, the C++ loader, is one of :data:`LATER_FLAGS`).
    ``args`` are forwarded (``seq_len``)."""
    return dataset.batches(cfg.batch_size, *args, skip=skip)


def describe(cfg: TrainConfig, workload: str) -> str:
    fields = ", ".join(f"{f.name}={getattr(cfg, f.name)!r}" for f in dataclasses.fields(cfg))
    return f"[asyncsgd:{workload}] {fields}"


def run_spmd(
    cfg: TrainConfig,
    batches,
    loss_fn,
    init_params: Callable,
    *,
    tx,
    items_per_batch: int | None = None,
    step_attrs: dict | None = None,
    world=None,
) -> dict:
    """Drive the train step for ``cfg.steps`` steps on one rank, or over
    ``world``'s ranks (:func:`make_world`).

    ``init_params()`` gives the initial parameters, already bound to the
    model ``loss_fn(params, batch) -> (loss, aux)`` reads them through
    (the seam a caller uses to start from other weights, e.g. the JAX
    package's): one mapping, or with a ``world`` a list of one per rank
    beside a list of ``loss_fn``s. ``tx`` is the goo rule;
    ``items_per_batch`` the throughput unit (tokens per global batch for
    LM workloads); ``step_attrs`` label the loop's ``step`` spans, with
    ``grad_sync=`` the executed sync mode added."""
    reject_later_slices(cfg)
    device = resolve_device(cfg.device)
    init_fn, step_fn = make_train_step(
        loss_fn, tx, world, zero1=cfg.zero1, grad_sync=cfg.grad_sync,
        grad_bucket_mb=cfg.grad_bucket_mb,
    )
    state = init_fn(init_params())
    result = hardened_loop(
        state,
        step_fn,
        batches,
        steps=cfg.steps,
        device=device if world is None else world.device,
        items_per_batch=items_per_batch or cfg.batch_size,
        log_every=cfg.log_every,
        logger=MetricLogger(),
        spike_factor=cfg.spike_factor,
        fetch_lag=cfg.fetch_lag,
        prefetch_depth=cfg.prefetch_depth,
        step_attrs={**(step_attrs or {}), "grad_sync": step_fn.grad_sync_mode},
        world=world,
    )
    ranks = 1 if world is None else world.num_devices
    out = {
        "mode": "spmd",
        "world": f"{ranks} rank{'s' if ranks > 1 else ''} ({device})",
        "device": str(device),
        "ranks": ranks,
        "zero1": cfg.zero1,
        "grad_sync": step_fn.grad_sync_mode,
        "steps": result["steps"],
        "losses": result["losses"],
        "final_loss": result["final_loss"],
        "restores": result["restores"],
        "preempted": result["preempted"],
        "step_ms": result["step_ms"],
    }
    if world is not None:
        out["replicas_identical"] = result["state"].replicas_equal()
    for k in ("items_per_sec", "items_per_sec_last", "items_per_sec_mean"):
        if k in result:
            out[k] = result[k]
    return out
