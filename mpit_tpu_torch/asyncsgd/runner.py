"""Shared run harness of the port's training workloads: the port of
:mod:`mpit_tpu.asyncsgd.runner`.

Three execution paths, selected by ``--mode``:

- :func:`run_spmd` drives the train step (value and grad, gradient
  sync, goo update) for ``cfg.steps`` steps through
  :func:`mpit_tpu_torch.train.hardened_loop`: on one rank, or with
  ``--mesh data=N`` over a :class:`~mpit_tpu_torch.comm.World` of ``N``
  ranks (ZeRO-1 with ``--zero1``, the sync by ``--grad-sync`` in
  ``--grad-bucket-mb`` buckets), the global batch split over them; with
  an ``eval_fn``, the periodic val sweep (``--eval-every``) or one
  held-out batch at the end; with ``--ckpt-dir`` the checkpoint cadence
  (``--ckpt-every``), the resume (seek-based, through
  ``stream_factory``), the divergence restore (``--max-restores``) and
  the preemption checkpoint; ``--save-dense`` / ``--resume-dense`` the
  cross-geometry ``.npz`` shared with the JAX package;
- :func:`run_parity_classifier` runs the reference-shaped protocol: 1
  pserver + ``nranks - 1`` pclients exchanging tagged messages on the
  compat simulator (Downpour, or EASGD with ``--easgd true``), for
  semantics parity, not speed;
- :func:`run_elastic_classifier` (``mnist --mode elastic``) runs the
  elastic EASGD tier (:mod:`mpit_tpu_torch.train.elastic`): 1 anchor
  server + ``nranks - 1`` replicas, each on the hardened loop, through
  kills, hangs and NaNs.

:func:`run_classifier` is the classifiers' shared body (``mnist``,
``imagenet`` and, with ``stateful=True``, ``resnet``), and
:func:`classification_dataset` their data: the synthetic stream, or the
npy directory of ``--data-dir``, augmented with ``--augment``;
:func:`run_meta` the geometry pinned to a checkpoint directory.
Everything of the JAX harness that needs a later slice's machinery is
refused with ``SystemExit`` naming the slice that brings it: the flags
of :data:`LATER_FLAGS` (not fields of the port's config, so nothing can
read them by mistake) as the command line is parsed, and the values of
``--mesh`` that the port does not run by :func:`reject_later_slices`.
``--easgd true`` under ``--mode spmd`` chains the elastic term after
goo (:func:`build_tx`). ``--sentinel true`` wires the step-time
sentinel into the loop (SPMD) or the anchor server (elastic), and
``--profile-dir`` the SPMD loop's profile window; the SPMD run logs its
gradient sync's modeled wire bytes (:class:`~mpit_tpu_torch.utils.CommModel`,
returned as ``comm``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from mpit_tpu_torch.asyncsgd import actors
from mpit_tpu_torch.asyncsgd.config import TrainConfig
from mpit_tpu_torch.comm import init as init_world
from mpit_tpu_torch.data import FileClassification, shard_batch
from mpit_tpu_torch.opt import chain, elastic_average, goo, schedules
from mpit_tpu_torch.serve.engine import resolve_device
from mpit_tpu_torch.train import (
    CheckpointManager, MetricLogger, dense_from_dp, dp_from_dense, hardened_loop, load_dense,
    make_eval_step, make_train_step, save_dense,
)
from mpit_tpu_torch.opt.sharded import FlatLayout
from mpit_tpu_torch.train.step import FlatReplicas, TrainState
from mpit_tpu_torch.utils.profiling import CommModel, tree_bytes

__all__ = [
    "DATA_SLICE", "LATER_FLAGS", "accuracy", "base_tx", "build_tx", "classification_dataset",
    "describe",
    "make_sentinel", "make_stream", "make_val_sweep", "make_world", "refuse_dense",
    "refuse_elastic",
    "reject_later_slices",
    "run_classifier", "run_elastic_classifier", "run_meta", "run_parity_classifier", "run_spmd",
    "softmax_xent", "topk_accuracy",
]

DATA_SLICE = "the data-pipeline slice of the port (ROADMAP.md §A 12)"

# The JAX TrainConfig's flags that no code of the port reads -> the
# slice that brings them. Giving one raises SystemExit naming it.
LATER_FLAGS = {
    # The port's prefetch has one thread and a fixed depth.
    **dict.fromkeys(("native", "prefetch_workers", "prefetch_max_depth"), DATA_SLICE),
}


def reject_later_slices(cfg: TrainConfig, axes: tuple = ("data",)) -> None:
    """``SystemExit`` for the values of the config's fields that the
    port does not run: an unknown ``--mode``, a mesh axis outside
    ``axes`` (the workload's tiers: ``gpt2`` trains on the fsdp, model
    and seq axes too; the pipe and expert axes name §A 10), and, as in
    JAX, ``--augment-mode rrc`` or ``--train-size`` without
    ``--data-dir`` (the synthetic streams shift-crop only)."""
    if not cfg.data_dir and ((cfg.augment and cfg.augment_mode != "shift") or cfg.train_size):
        raise SystemExit(
            "--augment-mode rrc / --train-size need --data-dir (the synthetic streams "
            "implement shift-crop augmentation only)"
        )
    if cfg.mode not in ("spmd", "parity", "elastic"):
        raise SystemExit(f"--mode {cfg.mode}: spmd, parity or elastic")
    if cfg.profile_dir and cfg.mode != "spmd":
        raise SystemExit(
            f"--profile-dir with --mode {cfg.mode}: the profile window is the SPMD "
            "loop's; the parity and elastic modes run their ranks as compat threads"
        )
    mesh = cfg.mesh_shape() or {}
    if {"pipe", "expert"} & set(mesh):
        raise SystemExit(
            f"--mesh {cfg.mesh}: the pipe and expert axes arrive with the pipeline- and "
            "expert-parallel tiers (ROADMAP.md §A 10)"
        )
    if set(mesh) - set(axes):
        raise SystemExit(
            f"--mesh {cfg.mesh}: this workload trains on the {'/'.join(axes)} "
            f"{'axis' if len(axes) == 1 else 'axes'}; "
            "the fsdp, model and seq axes train gpt2 (its pjit and context-parallel "
            "tiers), and the port serves on the model axis "
            "(python -m mpit_tpu_torch.serve --mesh model=N)"
        )


def refuse_elastic(cfg: TrainConfig, workload: str) -> None:
    """``SystemExit`` for ``--mode elastic`` in a workload other than
    ``mnist``. The JAX package has no elastic branch there: its
    ``imagenet``, ``resnet`` and ``gpt2`` train SPMD under ``--mode
    elastic`` without a word (ROADMAP.md §C); the port says so."""
    if cfg.mode == "elastic":
        raise SystemExit(
            f"{workload} --mode elastic: the elastic tier trains mnist only; the JAX "
            f"package's {workload} has no elastic branch (it trains SPMD instead)"
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
    ``args`` are forwarded (``seq_len``); ``skip`` fast-forwards past the
    batches a resumed run already consumed, in O(1)."""
    return dataset.batches(cfg.batch_size, *args, skip=skip)


def run_meta(cfg: TrainConfig) -> dict:
    """The fields pinned to a checkpoint directory
    (:meth:`~mpit_tpu_torch.train.CheckpointManager.ensure_meta`):
    JAX's ``run_meta``, the same dict for the same flags. Everything the
    resumed run's equality to the uninterrupted one depends on: the lr
    curve, the optimizer, the data order (batch size, seed, ``data_dir``
    made absolute, the augmentation) and the stream that draws it
    (``python``: the port has no native core yet, ROADMAP.md §A 12); the
    gradient-sync wire (``ring_q8`` is lossy, its bucket size sets its
    scales); and every field a workload's config adds, pinned
    wholesale."""
    meta = {
        **schedules.geometry(cfg),
        "momentum": cfg.momentum,
        "weight_decay": cfg.weight_decay,
        "batch_size": cfg.batch_size,
        "seed": cfg.seed,
        "data_dir": os.path.abspath(cfg.data_dir) if cfg.data_dir else "",
        "stream_impl": "python",
        "augment": cfg.augment,
        "augment_mode": cfg.augment_mode if cfg.augment else "",
        "crop_pad": cfg.crop_pad if cfg.augment else 0,
        "train_size": cfg.train_size,
        "easgd": cfg.easgd,
        "grad_sync": cfg.grad_sync,
    }
    if cfg.grad_sync == "ring_q8":
        meta["grad_q8_bucket_mb"] = cfg.grad_bucket_mb
    if cfg.easgd:
        meta["easgd_alpha"] = cfg.easgd_alpha
    base_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    for f in dataclasses.fields(type(cfg)):
        if f.name not in base_fields:
            meta[f.name] = getattr(cfg, f.name)
    return meta


def make_sentinel(cfg: TrainConfig):
    """The step-time anomaly sentinel of ``--sentinel true``, or None."""
    if not cfg.sentinel:
        return None
    from mpit_tpu_torch.obs import Sentinel

    return Sentinel()


def refuse_dense(cfg: TrainConfig, stateful: bool) -> None:
    """JAX's refusal: the dense format carries the ZeRO-1 DP layout and
    no stateful extras (BatchNorm statistics). The workloads call it
    before they build a model; :func:`run_spmd` again for its callers."""
    if (cfg.resume_dense or cfg.save_dense) and (not cfg.zero1 or stateful):
        raise SystemExit(
            "--resume-dense/--save-dense convert the ZeRO-1 DP layout; "
            "run with --zero1 true, a stateless model (BatchNorm "
            "models use same-geometry --ckpt-dir resume), and a single "
            "controller process (multi-host runs checkpoint via "
            "--ckpt-dir)"
        )


def describe(cfg: TrainConfig, workload: str) -> str:
    fields = ", ".join(f"{f.name}={getattr(cfg, f.name)!r}" for f in dataclasses.fields(cfg))
    return f"[asyncsgd:{workload}] {fields}"


# ---- classification metrics (JAX's, on logits [B, C] and labels [B]) ----


def _wmean(per_example, valid):
    """Mean over the real rows only: ``valid`` is the pad mask of a val
    batch padded to the batch size (None: every row counts)."""
    if valid is None:
        return per_example.mean()
    valid = valid.to(per_example.dtype)
    return (per_example * valid).sum() / valid.sum().clamp_min(1.0)


def softmax_xent(logits, labels, valid=None):
    """Mean cross entropy in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _wmean(-logp.gather(1, labels.long()[:, None])[:, 0], valid)


def accuracy(logits, labels, valid=None):
    """Top-1 accuracy (the first maximum wins a tie, as ``argmax`` in
    both frameworks)."""
    return _wmean((logits.argmax(-1) == labels).float(), valid)


def topk_accuracy(logits, labels, k: int = 5, valid=None):
    """Top-k accuracy (the ImageNet top-5 convention). At an exact tie
    for the k-th place ``torch.topk`` and ``lax.top_k`` may keep
    different classes."""
    idx = logits.topk(k, dim=-1).indices
    return _wmean((idx == labels[:, None]).any(-1).float(), valid)


def classification_dataset(cfg: TrainConfig, synthetic_factory):
    """``--data-dir`` selects the npy directory
    (:class:`~mpit_tpu_torch.data.FileClassification`, with the config's
    augmentation); else the synthetic stand-in from
    ``synthetic_factory()``, its train stream shift-cropped and flipped
    with ``--augment``. :func:`reject_later_slices` has refused what
    needs a directory."""
    if cfg.data_dir:
        return FileClassification(
            cfg.data_dir, seed=cfg.seed, augment=cfg.augment, augment_mode=cfg.augment_mode,
            crop_pad=cfg.crop_pad, train_size=cfg.train_size,
            rrc_scale=(cfg.rrc_min_scale, 1.0),
        )
    ds = synthetic_factory()
    ds.augment = cfg.augment
    ds.crop_pad = cfg.crop_pad
    return ds


def make_val_sweep(cfg: TrainConfig, dataset):
    """``() -> iterator`` over the val split for the periodic sweep
    (``run_spmd``'s ``val_sweep``); ``--eval-batches`` caps it, the
    synthetic datasets default to 8 held-out batches."""

    def sweep():
        return dataset.val_batches(cfg.eval_batch, num_batches=cfg.eval_batches or None)

    return sweep


def base_tx(cfg: TrainConfig):
    """The goo SGD rule of a config, with its lr schedule (constant when
    ``--schedule`` is empty): the parity clients' and the elastic
    replicas' local rule (JAX builds ``gopt.goo`` there directly)."""
    return goo(schedules.from_config(cfg), cfg.momentum, weight_decay=cfg.weight_decay)


def build_tx(cfg: TrainConfig, *, axis: str | None = None):
    """The SPMD step's rule (JAX's ``build_tx``): Downpour's goo, or with
    ``--easgd true`` goo chained with the elastic term over ``axis``
    (the SPMD spelling of the reference's elastic dynamics: the centre
    is the mean over the ranks, the pserver reduced to a collective).
    Under ZeRO-1 each rank's centre shard averages that shard of every
    replica (``opt/goo.py``), where the JAX package averages the
    devices' different shards (ROADMAP.md §C)."""
    base = base_tx(cfg)
    if cfg.easgd:
        return chain(base, elastic_average(cfg.easgd_alpha, axis=axis))
    return base


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_spmd(
    cfg: TrainConfig,
    batches,
    loss_fn,
    init_params: Callable,
    *,
    stateful: bool = False,
    tx=None,
    items_per_batch: int | None = None,
    step_attrs: dict | None = None,
    world=None,
    eval_fn=None,
    eval_batch: dict | None = None,
    val_sweep: Callable | None = None,
    stream_factory: Callable | None = None,
    dense_meta: dict | None = None,
    async_save: bool = True,
    final_save: bool = False,
    roofline: dict | None = None,
) -> dict:
    """Drive the train step for ``cfg.steps`` steps on one rank, or over
    ``world``'s ranks (:func:`make_world`).

    ``init_params()`` gives the initial parameters, already bound to the
    model ``loss_fn(params, batch) -> (loss, aux)`` reads them through
    (the seam a caller uses to start from other weights, e.g. the JAX
    package's): one mapping, or with a ``world`` a list of one per rank
    beside a list of ``loss_fn``s. With ``stateful`` (a BatchNorm model,
    :func:`mpit_tpu_torch.train.make_train_step`'s stateful form),
    ``init_params() -> (params, extra)``, ``extra`` the models' buffers
    likewise, and ``loss_fn`` and ``eval_fn`` take ``extra`` after
    ``params``. ``tx`` is the goo rule (default
    :func:`build_tx`); ``items_per_batch`` the throughput unit (tokens
    per global batch for LM workloads); ``step_attrs`` label the loop's
    ``step`` spans, with ``grad_sync=`` the executed sync mode added.

    ``eval_fn(params, batch) -> metrics`` (one per rank with a
    ``world``; :func:`mpit_tpu_torch.train.make_eval_step`'s contract):
    with ``val_sweep`` and ``--eval-every``, the val split's sweep every
    N steps and at the last, combined over the sweep as ``Σ m·w / Σ w``
    (``w``: a batch's ``_weight``, else 1); the result's ``eval`` is the
    last sweep, or else ``eval_fn`` on ``eval_batch`` at the end.

    Checkpoints (``--ckpt-dir``): a
    :class:`~mpit_tpu_torch.train.CheckpointManager` (``async_save``)
    pinned to :func:`run_meta`, saved every ``--ckpt-every`` steps (with
    ``final_save`` also at the end) and on a SIGTERM; a run over a
    directory with a checkpoint resumes from it, the stream rebuilt past
    the consumed batches by ``stream_factory(skip)`` (else ``batches``
    is drained that far). ``--resume-dense`` wins over the checkpoint
    unless the checkpoint is past its step (the choice is printed), and
    ``--save-dense`` writes the dense ``.npz`` on every exit path,
    ``dense_meta`` (``num_heads``, ``tie_head``) in it.

    ``--sentinel true`` and ``--profile-dir`` go to the loop, as does
    ``roofline`` (one step's modeled cost); the result then carries
    ``sentinel``, ``profile`` and ``roofline``. The gradient sync's
    modeled wire bytes a step (:class:`CommModel`, at the wire's width:
    ¼ of f32 for ``ring_q8``) are logged and returned as ``comm``."""
    reject_later_slices(cfg)
    refuse_dense(cfg, stateful)
    device = resolve_device(cfg.device)
    tx = build_tx(cfg, axis="data") if tx is None else tx
    init_fn, step_fn = make_train_step(
        loss_fn, tx, world, zero1=cfg.zero1, stateful=stateful, grad_sync=cfg.grad_sync,
        grad_bucket_mb=cfg.grad_bucket_mb,
    )
    init = init_params()
    state = init_fn(*init) if stateful else init_fn(init)
    first = init[0] if stateful else init
    first = first[0] if isinstance(first, list) else first
    gs = getattr(step_fn, "grad_sync", None)
    comm = CommModel(
        tree_bytes(first), 1 if world is None else world.num_devices, zero1=cfg.zero1,
        wire_scale=gs.wire_scale() if gs is not None else 1.0,
    )
    run_device = device if world is None else world.device
    ckpt = None
    if cfg.ckpt_dir:
        ckpt = CheckpointManager(cfg.ckpt_dir, world, async_save=async_save)
        ckpt.ensure_meta(run_meta(cfg), defaults=run_meta(type(cfg)()))
    # Restore-source resolution: the dense file bootstraps a new geometry
    # until the checkpoint has moved past its step; the choice is printed.
    use_dense = False
    if cfg.resume_dense:
        with np.load(cfg.resume_dense) as z:
            dense_step = int(z["__step__"])
        latest = ckpt.latest_step() if ckpt is not None else None
        use_dense = latest is None or latest <= dense_step
        print(
            "[asyncsgd] restore source: "
            + (f"dense {cfg.resume_dense} (step {dense_step})" if use_dense
               else f"checkpoint {cfg.ckpt_dir} (step {latest} > dense step {dense_step})")
        )
    if use_dense:
        dp_from_dense(load_dense(cfg.resume_dense), state, tx)
    elif ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(state)
    start_step = state.step
    if start_step and stream_factory is not None:
        batches = stream_factory(start_step)
    else:
        for skipped in range(start_step):
            try:
                next(batches)
            except StopIteration:
                raise RuntimeError(
                    f"checkpoint-resume needs to skip {start_step} consumed batches but the "
                    f"stream ended after {skipped} — the stream is shorter than the "
                    "checkpointed run (did the data config change between runs?)"
                ) from None

    def split(batch):
        return _on_device(batch, run_device) if world is None else shard_batch(world, batch)

    ev = None if eval_fn is None else make_eval_step(eval_fn, world, stateful=stateful)
    eval_hook = None
    if cfg.eval_every and ev is not None and val_sweep is not None:

        def eval_hook(state):
            totals: dict[str, float] = {}
            denom = 0.0
            for b in val_sweep():
                m = {k: float(v) for k, v in ev(state, split(b)).items()}
                w = m.pop("_weight", 1.0)
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + v * w
                denom += w
            return {k: v / denom for k, v in totals.items()} if denom else {}

    logger = MetricLogger()
    logger.log(start_step, {"comm_" + k: v for k, v in comm.summary().items()})
    try:
        result = hardened_loop(
            state,
            step_fn,
            batches,
            steps=cfg.steps,
            device=run_device,
            items_per_batch=items_per_batch or cfg.batch_size,
            log_every=cfg.log_every,
            logger=logger,
            ckpt=ckpt,
            ckpt_every=cfg.ckpt_every,
            max_restores=cfg.max_restores,
            final_save=final_save,
            spike_factor=cfg.spike_factor,
            fetch_lag=cfg.fetch_lag,
            prefetch_depth=cfg.prefetch_depth,
            step_attrs={**(step_attrs or {}), "grad_sync": step_fn.grad_sync_mode},
            world=world,
            eval_every=cfg.eval_every if eval_hook else 0,
            eval_hook=eval_hook,
            sentinel=make_sentinel(cfg),
            profile_dir=cfg.profile_dir,
            roofline=roofline,
        )
    finally:
        if ckpt is not None:
            ckpt.close()  # pending saves are durable, on every exit
    if cfg.save_dense:
        # Written on every exit path, the preemption drain included.
        save_dense(cfg.save_dense, dense_from_dp(result["state"], tx), **(dense_meta or {}))
        logger.log(result["state"].step, {"event": "dense_saved", "path": cfg.save_dense})
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
        "comm": comm.summary(),
    }
    for k in ("sentinel", "profile", "roofline", "compiles"):
        if k in result:
            out[k] = result[k]
    if world is not None:
        out["replicas_identical"] = result["state"].replicas_equal()
    for k in ("items_per_sec", "items_per_sec_last", "items_per_sec_mean"):
        if k in result:
            out[k] = result[k]
    if "eval" in result:  # the last val sweep
        out["eval"] = result["eval"]
    elif ev is not None and eval_batch is not None:
        out["eval"] = {k: float(v) for k, v in ev(result["state"], split(eval_batch)).items()}
    return out


# ---- the classifier workloads (mnist, imagenet, resnet) -------------------


def _classifier_fns(model, top5: bool, stateful: bool = False):
    """``(loss_fn, eval_fn)`` of a classifier bound to ``model``:
    softmax cross entropy with top-1 accuracy as the aux metric, and the
    eval metrics ``loss``, ``top1`` (``top5`` with ``top5``) and, for a
    batch with a ``valid`` mask, ``_weight``. With ``stateful`` (a
    BatchNorm model, ``forward(x, *, train)``) both take ``extra``, the
    model's own buffers: the loss runs ``train=True``, which steps them
    in place, and returns them as its new state; the eval runs
    ``train=False``, normalising with them."""

    def loss_fn(params, batch):
        del params  # the model's own parameters
        logits = model(batch["image"], train=True) if stateful else model(batch["image"])
        acc = accuracy(logits.detach(), batch["label"])
        return softmax_xent(logits, batch["label"]), {"accuracy": acc}

    def eval_fn(params, batch):
        del params
        logits = model(batch["image"], train=False) if stateful else model(batch["image"])
        v = batch.get("valid")
        out = {"loss": softmax_xent(logits, batch["label"], v),
               "top1": accuracy(logits, batch["label"], v)}
        if top5:
            out["top5"] = topk_accuracy(logits, batch["label"], 5, v)
        if v is not None:
            out["_weight"] = v.float().sum()
        return out

    if not stateful:
        return loss_fn, eval_fn

    def stateful_loss_fn(params, extra, batch):
        del extra  # the model's own buffers, which its forward steps
        return (*loss_fn(params, batch), dict(model.named_buffers()))

    def stateful_eval_fn(params, extra, batch):
        del extra
        return eval_fn(params, batch)

    return stateful_loss_fn, stateful_eval_fn


def run_classifier(cfg: TrainConfig, make_model: Callable, dataset, *, initial_params=None,
                   top5: bool = False, stateful: bool = False, fault_plan=None) -> dict:
    """A classifier workload's body: ``--mode parity`` through
    :func:`run_parity_classifier`, ``--mode elastic`` through
    :func:`run_elastic_classifier`, else :func:`run_spmd` with one model
    per rank, all from one set of weights (the seeded initialisation of
    ``make_model(device=..., generator=...)``, or ``initial_params``, a
    ``state_dict``), the eval of ``top1`` (and ``top5`` with ``top5``)
    on the held-out batch or the val sweep. ``stateful``: a BatchNorm
    model, its buffers the step's ``extra`` (averaged over the ranks
    after every step). ``fault_plan`` (``--mode elastic`` only): a
    :class:`~mpit_tpu_torch.compat.FaultPlan` for the fleet."""
    reject_later_slices(cfg)
    device = resolve_device(cfg.device)
    if cfg.mode == "parity":
        return run_parity_classifier(cfg, make_model, dataset, initial_params=initial_params)
    if cfg.mode == "elastic":
        return run_elastic_classifier(cfg, make_model, dataset, initial_params=initial_params,
                                      fault_plan=fault_plan)
    world = make_world(cfg, device)
    ranks = 1 if world is None else world.num_devices
    models = []
    if initial_params is None:
        models.append(make_model(device=device,
                                 generator=torch.Generator().manual_seed(cfg.seed)))
        initial_params = models[0].state_dict()
    for r in range(len(models), ranks):
        model = make_model(device=device if world is None else world.rank_device(r))
        model.load_state_dict(initial_params)
        models.append(model)
    fns = [_classifier_fns(m, top5, stateful) for m in models]
    params = [dict(m.named_parameters()) for m in models]
    extras = [dict(m.named_buffers()) for m in models]

    def init_params():
        if world is None:
            return (params[0], extras[0]) if stateful else params[0]
        return (params, extras) if stateful else params

    return run_spmd(
        cfg,
        make_stream(cfg, dataset),
        fns[0][0] if world is None else [f[0] for f in fns],
        init_params,
        stateful=stateful,
        world=world,
        eval_fn=fns[0][1] if world is None else [f[1] for f in fns],
        eval_batch=dataset.eval_batch(cfg.eval_batch),
        val_sweep=make_val_sweep(cfg, dataset),
        stream_factory=lambda skip: make_stream(cfg, dataset, skip=skip),
    )


def run_parity_classifier(cfg: TrainConfig, make_model: Callable, dataset, *,
                          initial_params=None) -> dict:
    """The reference-shaped path: 1 pserver + ``nranks - 1`` pclients on
    the compat simulator, every flat vector on the run's device.

    Downpour (default): each client fetches the parameters, computes a
    gradient on its own stream of batches and pushes it; the server
    applies goo SGD per message. EASGD (``--easgd true``): each client
    runs local goo steps and exchanges an elastic difference with the
    server's centre every ``--sync-every`` steps. The flat vector is the
    port's :class:`~mpit_tpu_torch.opt.sharded.FlatLayout` (JAX's leaf
    order, each leaf padded to 128 elements; the pads stay zero). Every
    client has its own model, its parameters views of its own flat
    buffer. ``--ps-timeout`` bounds the compat job."""
    device = resolve_device(cfg.device)
    nclients = max(cfg.nranks - 1, 1)
    seeded = initial_params is None
    first = make_model(device=device,
                       generator=torch.Generator().manual_seed(cfg.seed) if seeded else None)
    if not seeded:
        first.load_state_dict(initial_params)
    flat0 = FlatReplicas([dict(first.named_parameters())])
    layout, flat_init = flat0.layout, flat0.params[0]

    steps_per_client = max(cfg.steps // nclients, 1)
    per_client_batch = max(cfg.batch_size // nclients, 1)

    def client_fn(client: actors.PClient, widx: int):
        model = make_model(device=device)
        flat = FlatReplicas([dict(model.named_parameters())])
        params, grads = flat.params[0], flat.grads[0]
        loss_fn, _ = _classifier_fns(model, top5=False)
        leaves = flat.leaves[0]

        def loss_and_grad(batch):
            loss, _ = loss_fn(None, batch)
            g = torch.autograd.grad(loss, leaves)
            torch._foreach_copy_(flat.grad_views[0], g)
            return loss.detach()

        stream = dataset.batches(per_client_batch, seed=cfg.seed + 100 + widx)
        losses = []
        if cfg.easgd:
            local_tx = base_tx(cfg)
            with torch.no_grad():
                params.copy_(flat_init)
            opt_state = local_tx.init([params])
            for step in range(steps_per_client):
                loss = loss_and_grad(_on_device(next(stream), device))
                with torch.no_grad():
                    (update,) = local_tx.update([grads], opt_state, [params])
                    params.add_(update)
                    if (step + 1) % cfg.sync_every == 0:
                        params.copy_(client.elastic_exchange(params, cfg.easgd_alpha))
                losses.append(loss)
        else:
            for _ in range(steps_per_client):
                with torch.no_grad():
                    params.copy_(client.fetch())  # a copy before the next fetch
                loss = loss_and_grad(_on_device(next(stream), device))
                client.push_grad(grads)
                losses.append(loss)
        return [float(x) for x in losses]

    t0 = time.perf_counter()
    results = actors.run_parameter_server(
        flat_init, base_tx(cfg), client_fn, nranks=nclients + 1,
        easgd_alpha=cfg.easgd_alpha, timeout=cfg.ps_timeout,
    )
    wall_s = time.perf_counter() - t0
    final_flat, client_losses = results[actors.SERVER_RANK], results[1:]

    # The final model's eval, on the server's canonical parameters.
    with torch.no_grad():
        for name, view in layout.views(final_flat).items():
            first.get_parameter(name).copy_(view)
        eval_b = _on_device(dataset.eval_batch(cfg.eval_batch), device)
        logits = first(eval_b["image"])
        acc = float(accuracy(logits, eval_b["label"]))
        eval_loss = float(softmax_xent(logits, eval_b["label"]))
    return {
        "mode": "parity",
        "protocol": "easgd" if cfg.easgd else "downpour",
        "nranks": cfg.nranks,
        "device": str(device),
        "flat_len": layout.total,
        "wall_s": wall_s,
        "losses": [sum(c) / len(c) for c in zip(*client_losses)],
        "first_loss": client_losses[0][0],
        "final_loss": client_losses[0][-1],
        "eval": {"accuracy": acc, "loss": eval_loss},
    }


def run_elastic_classifier(cfg: TrainConfig, make_model: Callable, dataset, *,
                           initial_params=None, fault_plan=None) -> dict:
    """The elastic EASGD tier (:mod:`mpit_tpu_torch.train.elastic`): 1
    anchor server + ``nranks - 1`` replicas on the compat simulator, each
    on the hardened loop with its own model, whose parameters are views
    of its flat f32 vector on the run's device (the
    :class:`~mpit_tpu_torch.opt.sharded.FlatLayout` buffer), goo SGD on
    it, an anchor exchange every ``--sync-every`` steps, heartbeats and
    leases (``--heartbeat-s``, ``--lease-s``), ``--easgd-alpha`` or
    ``α = --easgd-beta / N_active``, quarantine and, with ``--ckpt-dir``,
    per-replica checkpoints for crash and rejoin. As JAX computes them:
    ``steps // replicas`` steps and ``batch_size // replicas`` images a
    replica, replica ``i``'s stream seeded ``seed + 100 + i``; the final
    eval runs on the anchor's centre. ``fault_plan``: seeded faults
    (kills, hangs, NaNs, slowdowns, message drops). ``--ps-timeout``
    bounds the compat job. On the card the model's first pass and the
    copy kernel's library are loaded before the fleet starts, so no
    first-use stall outlasts a lease."""
    from mpit_tpu_torch.train.elastic import ElasticConfig, run_elastic

    device = resolve_device(cfg.device)
    nreplicas = max(cfg.nranks - 1, 1)
    seeded = initial_params is None
    first = make_model(device=device,
                       generator=torch.Generator().manual_seed(cfg.seed) if seeded else None)
    if not seeded:
        first.load_state_dict(initial_params)
    init_sd = {k: v.detach().clone() for k, v in first.state_dict().items()}
    steps_per_replica = max(cfg.steps // nreplicas, 1)
    per_replica_batch = max(cfg.batch_size // nreplicas, 1)

    def init_replica():
        model = make_model(device=device)
        model.load_state_dict(init_sd)
        flat = FlatReplicas([dict(model.named_parameters())])
        params, grads, leaves = flat.params[0], flat.grads[0], flat.leaves[0]
        loss_fn, _ = _classifier_fns(model, top5=False)
        tx = base_tx(cfg)

        def step_fn(state, batch):
            loss, _ = loss_fn(None, batch)
            torch._foreach_copy_(flat.grad_views[0], torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                (update,) = tx.update([grads], state.opt_state, [params])
                params.add_(update)
            state.step += 1
            return state, {"loss": loss.detach()}

        return TrainState(step=0, params=params, opt_state=tx.init([params])), step_fn

    def stream_factory(ridx: int, skip: int):
        return dataset.batches(per_replica_batch, seed=cfg.seed + 100 + ridx, skip=skip)

    if device.type == "cuda":
        from mpit_tpu_torch.ops import kv_ship

        kv_ship.kernel_library()
        warm = _on_device(next(stream_factory(0, 0)), device)
        loss, _ = _classifier_fns(first, top5=False)[0](None, warm)
        loss.backward()
        first.zero_grad(set_to_none=True)
        torch.cuda.synchronize(device)
    ecfg = ElasticConfig(
        replicas=nreplicas, steps=steps_per_replica, sync_every=max(cfg.sync_every, 1),
        alpha=cfg.easgd_alpha, beta=cfg.easgd_beta, staleness_bound=cfg.staleness_bound,
        heartbeat_s=cfg.heartbeat_s, lease_s=cfg.lease_s, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, max_restores=cfg.max_restores, log_every=cfg.log_every,
        fetch_lag=cfg.fetch_lag,
    )
    out = run_elastic(ecfg, init_replica, stream_factory, fault_plan=fault_plan,
                      sentinel=make_sentinel(cfg), items_per_batch=per_replica_batch,
                      job_timeout_s=cfg.ps_timeout)

    # The final model's eval, on the anchor's centre (as the parity path
    # evaluates the server's parameters).
    layout = FlatLayout(dict(first.named_parameters()))
    with torch.no_grad():
        for name, view in layout.views(out["center"]).items():
            first.get_parameter(name).copy_(view)
        eval_b = _on_device(dataset.eval_batch(cfg.eval_batch), device)
        logits = first(eval_b["image"])
        acc = float(accuracy(logits, eval_b["label"]))
        eval_loss = float(softmax_xent(logits, eval_b["label"]))
    result = {
        "mode": "elastic",
        "protocol": "easgd",
        "device": str(device),
        "replicas": nreplicas,
        "steps_per_replica": steps_per_replica,
        "anchor_version": out["version"],
        "server": {k: v for k, v in out["server"].items() if k != "center"},
        "replica_stats": [{k: v for k, v in r.items() if k != "losses"}
                          for r in out["replicas"]],
        "losses": out["replicas"][0]["losses"],
        "final_loss": out["replicas"][0]["final_loss"],
        "eval": {"accuracy": acc, "loss": eval_loss},
    }
    for key in ("flight", "fault_events", "sentinel"):
        if key in out:
            result[key] = out[key]
    return result
