"""GPT-2 small training — baseline config #5 of the JAX package, on the
GPU.

The port of :mod:`mpit_tpu.asyncsgd.gpt2` in its ``shard_map+zero1``
tier, on one rank or with ``--mesh data=N`` over ``N`` ranks (one model
per rank, the global batch split over them, ZeRO-1, the gradient sync
of ``--grad-sync psum|ring|ring_q8``): :class:`mpit_tpu_torch.models.GPT2`
trained on the synthetic bigram stream (loss falls from ``log(vocab)`` toward
``log(branching)``) with ``goo_adam``, the fused streaming LM-head loss
and, by default, bf16 head products with f32 results. ``--flash true``
plugs the flash-attention kernels in as the model's ``attention_fn``
(:func:`mpit_tpu_torch.ops.flash_attention.flash_attention`); ``--flash
false`` the plain :func:`~mpit_tpu_torch.models.gpt2.default_attention`.

    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true
    python -m mpit_tpu_torch.asyncsgd gpt2 --device cpu --steps 3 \\
        --vocab-size 128 --seq-len 32 --num-layers 2 --num-heads 2 --d-model 32
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4 \\
        --zero1 true --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4 --steps 20 \\
        --ckpt-dir runs/gpt2 --ckpt-every 10 --save-dense runs/gpt2.npz
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=2 --steps 40 \\
        --resume-dense runs/gpt2.npz
    python -m mpit_tpu_torch.serve --ckpt runs/gpt2.npz

Checkpoints (``--ckpt-dir``, the dense tier's contract in JAX): saved
synchronously every ``--ckpt-every`` steps and at the natural end, a
resume seeks the token stream past the consumed batches.
``--save-dense`` writes the cross-geometry ``.npz`` with ``num_heads``
and ``tie_head`` in its meta, so ``serve --ckpt`` (and the JAX
package's ``load_gpt2_params``) reads it without guessing.

``--sentinel true`` runs the step-time sentinel over the steps' device
times and ``--profile-dir DIR`` traces steps 2..5 with ``torch.profiler``
(a Chrome trace with the kernels' device events in ``DIR/trace.json``);
the result's ``roofline`` holds each step's analytic cost against its
device seconds.

    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --steps 10 \\
        --sentinel true --profile-dir runs/gpt2_profile

Two more tiers, routed by the mesh as JAX routes them, each trained
through the hardened loop (``--ckpt-dir`` resume seeking the stream,
``--sentinel``, ``--profile-dir``):

- ``--mesh data=N,model=M`` (or ``model=M``; ``--fsdp-axis AXIS`` with
  ``AXIS`` ``data`` or an ``fsdp`` axis of the mesh): the pjit tier,
  ``pjit-tp`` or ``pjit-tp+fsdp``
  (:func:`mpit_tpu_torch.parallel.tp.make_tp_train_step` with JAX's
  :func:`~mpit_tpu_torch.parallel.tp.gpt2_tp_rules`):
  :class:`~mpit_tpu_torch.serve.tp.TPGPT2`, each rank's ``H/M`` heads
  through ``--flash``'s kernels, the unfused head vocab-parallel (as
  JAX's tier is unfused), ``wte`` padded to a multiple of ``M`` (JAX's
  rule cannot lay out 50257 rows over an even ``M``: ROADMAP.md §C);
- ``--mesh data=N,seq=S`` (or ``seq=S``, given ``data=1``): the
  context-parallel tier, ``cp-ring``, ``cp-ring-flash``, ``cp-ulysses``
  or ``cp-ulysses-flash`` (``--ulysses``, ``--flash``;
  :func:`mpit_tpu_torch.parallel.cp.make_gpt2_cp_train_step`).

    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=2,model=2 \\
        --fsdp-axis data
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=2,seq=4
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4,seq=2 --ulysses true

What JAX's tier ignores the port refuses, with the reason: on the pjit
tier ``--zero1 false`` and ``--grad-sync ring|ring_q8``; on the CP tier
``--grad-sync ring|ring_q8``; on both ``--save-dense`` and
``--resume-dense``; ``--fsdp-axis`` off the pjit tier and ``--ulysses``
off the CP tier. The 3-D tiers (``seq`` with ``model``, ``model`` with
``pipe``), the pipe and expert axes and their flags raise
``SystemExit`` naming ROADMAP.md §A 10.
"""

from __future__ import annotations

import dataclasses

import torch

from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import SyntheticLM
from mpit_tpu_torch.models import GPT2, GPT2Config, default_attention
from mpit_tpu_torch.opt import goo_adam, schedules
from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.parallel.cp import make_gpt2_cp_train_step
from mpit_tpu_torch.parallel.tp import gpt2_tp_rules, make_tp_train_step
from mpit_tpu_torch.serve.engine import resolve_device
from mpit_tpu_torch.serve.tp import TPGPT2
from mpit_tpu_torch.serve.weights import shard_gpt2_params
from mpit_tpu_torch.train import CheckpointManager, hardened_loop
from mpit_tpu_torch.utils.profiling import gpt2_step_cost, tree_bytes

__all__ = ["GPT2TrainConfig", "main"]

# Flags of the JAX workload's other tiers -> the slice that brings them.
_LATER_TIER_FLAGS = {
    **dict.fromkeys(
        ("microbatches", "pp_schedule", "pp_chunks"),
        "the pipeline-parallel tier (ROADMAP.md §A 10)",
    ),
    **dict.fromkeys(
        ("moe_experts", "moe_k", "moe_capacity", "moe_every", "aux_weight"),
        "the expert-parallel tier (ROADMAP.md §A 10)",
    ),
}
# The mesh axes gpt2 trains on (its shard_map, pjit and CP tiers).
_AXES = ("data", "fsdp", "model", "seq")
# The classifiers' image-augmentation flags, which no token stream reads.
_IMAGE_FLAGS = ("augment", "augment_mode", "crop_pad", "train_size", "rrc_min_scale")


@dataclasses.dataclass
class GPT2TrainConfig(TrainConfig):
    vocab_size: int = 50257
    seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    remat: bool = False
    flash: bool = False  # the flash-attention CUDA kernels
    ulysses: bool = False  # cp tier: all-to-all Ulysses instead of the ring
    lr: float = 3e-4
    batch_size: int = 8
    fsdp_axis: str = ""  # e.g. "data" to compose ZeRO-3 with TP (pjit tier)
    fused_loss: bool = True  # streaming LM-head xent (ops/lm_head.py)
    bf16_head: bool = True  # bf16 head-product operands, f32 results

    def model_config(self) -> GPT2Config:
        return GPT2Config(
            vocab_size=self.vocab_size,
            max_seq_len=self.seq_len,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            d_model=self.d_model,
            remat=self.remat,
            attention_fn=flash_attention if self.flash else default_attention,
            head_dtype=torch.bfloat16 if self.bf16_head else torch.float32,
        )


def main(argv: list[str] | None = None, *, initial_params=None, **overrides) -> dict:
    """Train GPT-2 as the flags say. ``initial_params`` (a ``state_dict``,
    e.g. ``params_from_jax`` of the JAX package's ``model.init``) replaces
    the seeded initialisation; ``overrides`` replace flag values."""
    cfg = from_argv(
        GPT2TrainConfig, argv, prog="asyncsgd.gpt2", overrides=overrides,
        later={**runner.LATER_FLAGS, **_LATER_TIER_FLAGS},
    )
    if cfg.mode == "parity":
        raise SystemExit(
            "gpt2 is SPMD-only: it exists to exercise the parallel tiers, "
            "not the legacy async protocol"
        )
    if cfg.data_dir:
        raise SystemExit(
            f"--data-dir {cfg.data_dir}: gpt2's on-disk token stream (FileLM) arrives with "
            f"{runner.DATA_SLICE}"
        )
    for name in _IMAGE_FLAGS:
        if getattr(cfg, name) != getattr(TrainConfig, name):
            raise SystemExit(
                f"--{name.replace('_', '-')} {getattr(cfg, name)}: image augmentation, which "
                f"gpt2's token streams (the synthetic one, and FileLM with {runner.DATA_SLICE}) "
                "do not have"
            )
    runner.reject_later_slices(cfg, axes=_AXES)
    runner.refuse_elastic(cfg, "gpt2")
    if cfg.easgd:
        raise SystemExit(
            "gpt2 --easgd true: the JAX package's gpt2 trains its own goo_adam and "
            "ignores --easgd (it trains without the elastic term); the port refuses it"
        )
    mesh = cfg.mesh_shape() or {}
    _refuse_tier_flags(cfg, mesh)
    tiered = bool({"model", "seq"} & set(mesh))
    if not tiered:
        runner.refuse_dense(cfg, stateful=False)
    print(runner.describe(cfg, "gpt2"))
    if tiered:
        return _tier_main(cfg, mesh, initial_params)
    device = resolve_device(cfg.device)
    world = runner.make_world(cfg, device)
    ranks = 1 if world is None else world.num_devices
    dataset = SyntheticLM(vocab_size=cfg.vocab_size, seed=cfg.seed)
    mcfg = cfg.model_config()
    # One model per rank, each on its rank's device, all from one set of
    # weights (JAX's replicated params).
    if initial_params is None:
        first = GPT2(mcfg, device=device, generator=torch.Generator().manual_seed(cfg.seed))
        initial_params = first.state_dict()
        models = [first]
    else:
        models = []
    for r in range(len(models), ranks):
        model = GPT2(mcfg, device=device if world is None else world.rank_device(r))
        model.load_state_dict(initial_params)
        models.append(model)

    def loss_for(model):
        def loss_fn(params, batch):
            del params  # the model's own parameters
            tokens = batch["tokens"].long()
            if cfg.fused_loss:
                return GPT2.fused_loss_fn(model, tokens), {}
            return GPT2.loss_fn(model(tokens[:, :-1]), tokens), {}

        return loss_fn

    tx = goo_adam(schedules.from_config(cfg), weight_decay=cfg.weight_decay)
    loss_fns = [loss_for(m) for m in models]
    params = [dict(m.named_parameters()) for m in models]
    # One step's analytic cost over the global batch (every rank's share,
    # all on the one card), against the activations' arithmetic peak.
    roofline = gpt2_step_cost(
        mcfg, "train", slots=cfg.batch_size, width=cfg.seq_len, ctx=cfg.seq_len,
        param_bytes=tree_bytes(params[0]),
    )
    roofline["dtype"] = "bf16" if mcfg.dtype == torch.bfloat16 else "f32"
    out = runner.run_spmd(
        cfg,
        runner.make_stream(cfg, dataset, cfg.seq_len),
        loss_fns[0] if world is None else loss_fns,
        lambda: params[0] if world is None else params,
        tx=tx,
        items_per_batch=cfg.batch_size * cfg.seq_len,
        step_attrs={"attention": "flash" if cfg.flash else "plain"},
        world=world,
        stream_factory=lambda skip: runner.make_stream(cfg, dataset, cfg.seq_len, skip=skip),
        dense_meta={"num_heads": mcfg.num_heads, "tie_head": mcfg.tie_head},
        async_save=False,
        final_save=True,
        roofline=roofline,
    )
    out.update(
        tier="shard_map+zero1",
        attention="flash" if cfg.flash else "plain",
        uniform_loss=dataset.uniform_loss,
        optimal_loss=dataset.optimal_loss,
    )
    return out


def _refuse_tier_flags(cfg: GPT2TrainConfig, mesh: dict) -> None:
    """``SystemExit`` for a mesh the port does not train and for what the
    chosen tier of JAX's workload would ignore, each with its reason."""
    axes = set(mesh)
    if {"seq", "model"} <= axes:
        raise SystemExit(
            f"--mesh {cfg.mesh}: the 3-D dp-cp-tp tier (seq with model) arrives with "
            "the other training tiers (ROADMAP.md §A 10)"
        )
    if "fsdp" in axes and "model" not in axes:
        raise SystemExit(
            f"--mesh {cfg.mesh}: the fsdp axis composes with the model axis (the pjit "
            "tier, --mesh fsdp=F,model=M --fsdp-axis fsdp)"
        )
    if cfg.ulysses and "seq" not in axes:
        raise SystemExit(
            "gpt2: --ulysses true requires the cp tier (a mesh with a seq axis, e.g. "
            "--mesh data=4,seq=2)"
        )
    if cfg.fsdp_axis and "model" not in axes:
        raise SystemExit(
            f"--fsdp-axis {cfg.fsdp_axis}: FSDP composes with tensor parallelism on the "
            "pjit tier (--mesh data=N,model=M); JAX's other tiers ignore the flag"
        )
    if cfg.fsdp_axis and cfg.fsdp_axis not in axes:
        raise SystemExit(f"--fsdp-axis {cfg.fsdp_axis}: not an axis of --mesh {cfg.mesh}")
    if not ({"model", "seq"} & axes):
        return
    tier = "pjit" if "model" in axes else "cp"
    if cfg.grad_sync != "psum":
        raise SystemExit(
            f"--grad-sync {cfg.grad_sync}: JAX's {tier} tier ignores it (its gradients "
            "are reduced by XLA's own collectives), so the port refuses it there"
        )
    if tier == "pjit" and not cfg.zero1:
        raise SystemExit(
            "--zero1 false: JAX's pjit tier ignores --zero1 (its optimizer state follows "
            "the parameters' specs, cut with --fsdp-axis), so the port refuses it there"
        )
    if cfg.save_dense or cfg.resume_dense:
        raise SystemExit(
            f"--save-dense/--resume-dense: JAX's {tier} tier ignores them (only its "
            "shard_map tier converts the dense file); use --ckpt-dir there"
        )
    if not cfg.fused_loss and tier == "cp":
        raise SystemExit(
            "gpt2: --fused-loss false is only honored on the DP and pjit-TP tiers; the "
            "cp tier hardcodes the fused streaming LM-head xent (ops/lm_head.py)"
        )


def _tier_main(cfg: GPT2TrainConfig, mesh: dict, initial_params) -> dict:
    """The pjit tier (a model axis) or the CP tier (a seq axis), on one
    device: the World's ranks, the tier's step over a one-rank ``state_dict``
    (``initial_params``, else the seeded initialisation), the hardened
    loop (JAX's ``drive``)."""
    device = resolve_device(cfg.device)
    dataset = SyntheticLM(vocab_size=cfg.vocab_size, seed=cfg.seed)
    mcfg = cfg.model_config()
    if initial_params is None:
        initial_params = GPT2(mcfg, generator=torch.Generator().manual_seed(cfg.seed)).state_dict()
    tx = goo_adam(schedules.from_config(cfg), weight_decay=cfg.weight_decay)
    if "model" in mesh:
        world = comm.init(mesh, devices=[device])
        m = world.axis_size("model")
        model = TPGPT2(mcfg, m, device=device, vocab_parallel=True)
        model.load_state_dict(shard_gpt2_params(initial_params, m, vocab_parallel=True))

        def loss_fn(params, batch):
            del params  # the model's own (the working layout)
            tokens = batch["tokens"].long()
            return model(tokens[:, :-1], targets=tokens[:, 1:]).mean(), {}

        init_fn, step_fn, _ = make_tp_train_step(
            loss_fn, tx, world, gpt2_tp_rules("model"), fsdp_axis=cfg.fsdp_axis or None
        )
        state = init_fn(dict(model.named_parameters()))
        step = step_fn
        tier = "pjit-tp" + ("+fsdp" if cfg.fsdp_axis else "")
    else:
        world = comm.init({"data": 1, **mesh}, devices=[device])
        init_fn, step_fn, _ = make_gpt2_cp_train_step(
            mcfg, tx, world, zero1=cfg.zero1, flash=cfg.flash, ulysses=cfg.ulysses
        )
        state = init_fn(initial_params)

        def step(st, batch):
            return step_fn(st, {"tokens": batch["tokens"][:, : cfg.seq_len]})

        tier = ("cp-ulysses" if cfg.ulysses else "cp-ring") + ("-flash" if cfg.flash else "")
    ckpt = None
    start = 0
    if cfg.ckpt_dir:
        ckpt = CheckpointManager(cfg.ckpt_dir, world, async_save=False)
        ckpt.ensure_meta(runner.run_meta(cfg), defaults=runner.run_meta(type(cfg)()))
        if ckpt.latest_step() is not None:
            ckpt.restore(state)
            start = state.step
    roofline = gpt2_step_cost(
        mcfg, "train", slots=cfg.batch_size, width=cfg.seq_len, ctx=cfg.seq_len,
        param_bytes=tree_bytes(initial_params),
    )
    roofline["dtype"] = "bf16" if mcfg.dtype == torch.bfloat16 else "f32"
    try:
        result = hardened_loop(
            state, step, runner.make_stream(cfg, dataset, cfg.seq_len, skip=start),
            steps=cfg.steps, device=device, items_per_batch=cfg.batch_size * cfg.seq_len,
            log_every=cfg.log_every, ckpt=ckpt, ckpt_every=cfg.ckpt_every,
            max_restores=cfg.max_restores, final_save=True, spike_factor=cfg.spike_factor,
            fetch_lag=cfg.fetch_lag, prefetch_depth=cfg.prefetch_depth,
            step_attrs={"tier": tier, "attention": "flash" if cfg.flash else "plain"},
            sentinel=runner.make_sentinel(cfg), profile_dir=cfg.profile_dir, roofline=roofline,
        )
    finally:
        if ckpt is not None:
            ckpt.close()
    if hasattr(step_fn, "gather"):
        step_fn.gather(result["state"])  # the model's working parameters, current
    out = {
        "mode": "spmd",
        "tier": tier,
        "world": f"{dict(world.shape)} ranks ({device})",
        "device": str(device),
        "ranks": world.num_devices,
        "attention": "flash" if cfg.flash else "plain",
        "steps": result["steps"],
        "losses": result["losses"],
        "final_loss": result["final_loss"],
        "restores": result["restores"],
        "preempted": result["preempted"],
        "step_ms": result["step_ms"],
        "uniform_loss": dataset.uniform_loss,
        "optimal_loss": dataset.optimal_loss,
    }
    for k in ("sentinel", "profile", "roofline", "compiles", "items_per_sec",
              "items_per_sec_last", "items_per_sec_mean"):
        if k in result:
            out[k] = result[k]
    return out


if __name__ == "__main__":
    print(main())
