"""Shared run harness of the port's training workloads: the port of
:mod:`mpit_tpu.asyncsgd.runner`.

Two execution paths, selected by ``--mode``:

- :func:`run_spmd` drives the train step (value and grad, gradient
  sync, goo update) for ``cfg.steps`` steps through
  :func:`mpit_tpu_torch.train.hardened_loop`: on one rank, or with
  ``--mesh data=N`` over a :class:`~mpit_tpu_torch.comm.World` of ``N``
  ranks (ZeRO-1 with ``--zero1``, the sync by ``--grad-sync`` in
  ``--grad-bucket-mb`` buckets), the global batch split over them; with
  an ``eval_fn``, the periodic val sweep (``--eval-every``) or one
  held-out batch at the end;
- :func:`run_parity_classifier` runs the reference-shaped protocol: 1
  pserver + ``nranks - 1`` pclients exchanging tagged messages on the
  compat simulator (Downpour, or EASGD with ``--easgd true``), for
  semantics parity, not speed.

:func:`run_classifier` is the classifiers' shared body (``mnist``,
``imagenet`` and, with ``stateful=True``, ``resnet``), and
:func:`classification_dataset` their data: the synthetic stream, or the
npy directory of ``--data-dir``, augmented with ``--augment``.
Everything of the JAX harness that needs a checkpoint directory or a
later slice's machinery is refused with ``SystemExit`` naming the slice
that brings it: the flags of :data:`LATER_FLAGS` (not fields of the
port's config, so nothing can read them by mistake) as the command line
is parsed, and the values of ``--mode``, ``--mesh`` and ``--easgd`` that
the port does not run by :func:`reject_later_slices`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from mpit_tpu_torch.asyncsgd import actors
from mpit_tpu_torch.asyncsgd.config import TrainConfig
from mpit_tpu_torch.comm import init as init_world
from mpit_tpu_torch.data import FileClassification, shard_batch
from mpit_tpu_torch.opt import goo, schedules
from mpit_tpu_torch.serve.engine import resolve_device
from mpit_tpu_torch.train import MetricLogger, hardened_loop, make_eval_step, make_train_step
from mpit_tpu_torch.train.step import FlatReplicas

__all__ = [
    "DATA_SLICE", "LATER_FLAGS", "accuracy", "build_tx", "classification_dataset", "describe",
    "make_stream", "make_val_sweep", "make_world", "reject_later_slices", "run_classifier",
    "run_parity_classifier", "run_spmd", "softmax_xent", "topk_accuracy",
]

_CHECKPOINT = "the checkpoint slice of the port"
_OBSERVABILITY = "the observability slice of the port"
DATA_SLICE = "the data-pipeline slice of the port (ROADMAP.md §A 12)"
_ELASTIC = "the elastic slice of the port, after checkpoints (ROADMAP.md §A 6)"

# The JAX TrainConfig's flags that no code of the port reads -> the
# slice that brings them. Giving one raises SystemExit naming it.
LATER_FLAGS = {
    **dict.fromkeys(("easgd_beta", "lease_s", "heartbeat_s", "staleness_bound"), _ELASTIC),
    # The port's prefetch has one thread and a fixed depth.
    **dict.fromkeys(("native", "prefetch_workers", "prefetch_max_depth"), DATA_SLICE),
    **dict.fromkeys(
        ("ckpt_dir", "ckpt_every", "save_dense", "resume_dense", "max_restores"), _CHECKPOINT
    ),
    **dict.fromkeys(("profile_dir", "sentinel"), _OBSERVABILITY),
}


def reject_later_slices(cfg: TrainConfig) -> None:
    """``SystemExit`` for the values of the config's fields that the
    port does not run: ``--mode elastic``, ``--easgd true`` under
    ``--mode spmd`` (``goo.elastic_average``), a mesh axis other than
    ``data``, and, as in JAX, ``--augment-mode rrc`` or ``--train-size``
    without ``--data-dir`` (the synthetic streams shift-crop only)."""
    if not cfg.data_dir and ((cfg.augment and cfg.augment_mode != "shift") or cfg.train_size):
        raise SystemExit(
            "--augment-mode rrc / --train-size need --data-dir (the synthetic streams "
            "implement shift-crop augmentation only)"
        )
    if cfg.mode not in ("spmd", "parity"):
        raise SystemExit(f"--mode {cfg.mode}: arrives with {_ELASTIC}")
    if cfg.easgd and cfg.mode == "spmd":
        raise SystemExit(
            f"--easgd true under --mode spmd (goo.elastic_average): arrives with {_ELASTIC}"
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


def build_tx(cfg: TrainConfig):
    """The goo SGD rule of a config (Downpour), with its lr schedule
    (constant when ``--schedule`` is empty). EASGD under SPMD
    (``goo.elastic_average``) is refused by :func:`reject_later_slices`."""
    return goo(schedules.from_config(cfg), cfg.momentum, weight_decay=cfg.weight_decay)


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
    last sweep, or else ``eval_fn`` on ``eval_batch`` at the end."""
    reject_later_slices(cfg)
    device = resolve_device(cfg.device)
    init_fn, step_fn = make_train_step(
        loss_fn, build_tx(cfg) if tx is None else tx, world, zero1=cfg.zero1,
        stateful=stateful, grad_sync=cfg.grad_sync, grad_bucket_mb=cfg.grad_bucket_mb,
    )
    state = init_fn(*init_params()) if stateful else init_fn(init_params())
    run_device = device if world is None else world.device

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

    result = hardened_loop(
        state,
        step_fn,
        batches,
        steps=cfg.steps,
        device=run_device,
        items_per_batch=items_per_batch or cfg.batch_size,
        log_every=cfg.log_every,
        logger=MetricLogger(),
        spike_factor=cfg.spike_factor,
        fetch_lag=cfg.fetch_lag,
        prefetch_depth=cfg.prefetch_depth,
        step_attrs={**(step_attrs or {}), "grad_sync": step_fn.grad_sync_mode},
        world=world,
        eval_every=cfg.eval_every if eval_hook else 0,
        eval_hook=eval_hook,
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
                   top5: bool = False, stateful: bool = False) -> dict:
    """A classifier workload's body: ``--mode parity`` through
    :func:`run_parity_classifier`, else :func:`run_spmd` with one model
    per rank, all from one set of weights (the seeded initialisation of
    ``make_model(device=..., generator=...)``, or ``initial_params``, a
    ``state_dict``), the eval of ``top1`` (and ``top5`` with ``top5``)
    on the held-out batch or the val sweep. ``stateful``: a BatchNorm
    model, its buffers the step's ``extra`` (averaged over the ranks
    after every step)."""
    reject_later_slices(cfg)
    device = resolve_device(cfg.device)
    if cfg.mode == "parity":
        return run_parity_classifier(cfg, make_model, dataset, initial_params=initial_params)
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
            local_tx = build_tx(cfg)
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
        flat_init, build_tx(cfg), client_fn, nranks=nclients + 1,
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
