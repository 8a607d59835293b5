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

Every other tier of the JAX workload (a mesh with a model, seq, pipe or
expert axis) and every flag of a later slice raises ``SystemExit``
naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses

import torch

from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import SyntheticLM
from mpit_tpu_torch.models import GPT2, GPT2Config, default_attention
from mpit_tpu_torch.opt import goo_adam, schedules
from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.serve.engine import resolve_device
from mpit_tpu_torch.utils.profiling import gpt2_step_cost, tree_bytes

__all__ = ["GPT2TrainConfig", "main"]

# Flags of the JAX workload's other tiers -> the slice that brings them.
_LATER_TIER_FLAGS = {
    "ulysses": "the context-parallel tier, after the ring-collectives slice",
    **dict.fromkeys(
        ("microbatches", "pp_schedule", "pp_chunks"),
        "the pipeline-parallel tier, after the ring-collectives slice",
    ),
    **dict.fromkeys(
        ("moe_experts", "moe_k", "moe_capacity", "moe_every", "aux_weight"),
        "the expert-parallel tier, after the ring-collectives slice",
    ),
    "fsdp_axis": "tensor-parallel training (ROADMAP.md §A 8b)",
}
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
    lr: float = 3e-4
    batch_size: int = 8
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
    runner.reject_later_slices(cfg)
    runner.refuse_elastic(cfg, "gpt2")
    if cfg.easgd:
        raise SystemExit(
            "gpt2 --easgd true: the JAX package's gpt2 trains its own goo_adam and "
            "ignores --easgd (it trains without the elastic term); the port refuses it"
        )
    runner.refuse_dense(cfg, stateful=False)
    print(runner.describe(cfg, "gpt2"))
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


if __name__ == "__main__":
    print(main())
