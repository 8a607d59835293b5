"""ImageNet ResNet-50: baseline config #4 (sync allreduce, sharded goo),
on the GPU. The port of :mod:`mpit_tpu.asyncsgd.resnet`.

The config exists for the synchronous gradient path with the goo state
sharded over the ranks: ``--mesh data=N --zero1 true`` with ``--grad-sync
psum|ring|ring_q8`` (the ring kernels, per gradient bucket). The
BatchNorm statistics ride the stateful step: every rank's running
averages are averaged over the ranks after each step, and the eval
normalises with them. ResNet-50 computes in bf16 with float32
parameters and statistics; ``--bn-impl flax`` swaps in flax's BatchNorm
arithmetic (other module names, as in JAX). ``--image-size`` and
``--num-classes`` shrink the workload for tests.

    python -m mpit_tpu_torch.asyncsgd resnet --steps 30 --batch-size 128
    python -m mpit_tpu_torch.asyncsgd resnet --mesh data=4 --zero1 true --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd resnet --data-dir /data/imagenet-npy --augment true \\
        --augment-mode rrc --train-size 224
    python -m mpit_tpu_torch.asyncsgd resnet --device cpu --image-size 32 --num-classes 10 \\
        --steps 2 --batch-size 4 --eval-batch 4

Data is the synthetic ImageNet stream (bit for bit the JAX package's),
or the npy directory of ``--data-dir``. SPMD only: ``--mode parity``
raises with JAX's reason.
"""

from __future__ import annotations

import dataclasses

from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import synthetic_imagenet
from mpit_tpu_torch.models import ResNet50
from mpit_tpu_torch.models.resnet import NORMS
from mpit_tpu_torch.serve.engine import resolve_device

__all__ = ["ResnetConfig", "main"]


@dataclasses.dataclass
class ResnetConfig(TrainConfig):
    image_size: int = 224
    num_classes: int = 1000
    lr: float = 0.1
    weight_decay: float = 1e-4
    # BatchNorm: "scale_shift" (models/norm.py's one-pass form) or "flax"
    # (flax's nn.BatchNorm arithmetic; its modules are named BatchNorm_<i>).
    bn_impl: str = "scale_shift"


def main(argv: list[str] | None = None, *, initial_params=None, **overrides) -> dict:
    """Train ResNet-50 as the flags say. ``initial_params`` (a
    ``state_dict``, the BatchNorm buffers included) replaces the seeded
    initialisation; ``overrides`` replace flag values."""
    cfg = from_argv(ResnetConfig, argv, prog="asyncsgd.resnet", overrides=overrides,
                    later=runner.LATER_FLAGS)
    if cfg.mode == "parity":
        raise SystemExit(
            "resnet50 is SPMD-only: the async parity protocol predates "
            "BatchNorm and has no defined semantics for its running stats"
        )
    if cfg.bn_impl not in NORMS:
        raise SystemExit(f"--bn-impl must be scale_shift or flax, got {cfg.bn_impl!r}")
    runner.reject_later_slices(cfg)
    runner.refuse_elastic(cfg, "resnet")
    runner.refuse_dense(cfg, stateful=True)
    resolve_device(cfg.device)  # fail before the dataset is built
    print(runner.describe(cfg, "imagenet-resnet50"))
    dataset = runner.classification_dataset(
        cfg,
        lambda: synthetic_imagenet(
            image_size=cfg.image_size, num_classes=cfg.num_classes, seed=cfg.seed
        ),
    )
    if cfg.data_dir:
        cfg = dataclasses.replace(
            cfg, num_classes=dataset.num_classes, image_size=dataset.image_shape[0]
        )

    def make_model(**kw):
        return ResNet50(num_classes=cfg.num_classes, norm=cfg.bn_impl, **kw)

    return runner.run_classifier(cfg, make_model, dataset, initial_params=initial_params,
                                 top5=cfg.num_classes > 5, stateful=True)


if __name__ == "__main__":
    print(main())
