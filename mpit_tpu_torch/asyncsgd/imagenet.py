"""ImageNet AlexNet: baseline config #3 and the headline workload, on
the GPU. The port of :mod:`mpit_tpu.asyncsgd.imagenet`.

``--mode spmd`` is the path that scales (sync data parallelism, ZeRO-1
shards of the goo state; ``--mesh data=N --grad-sync ring|ring_q8`` over
the ring kernels); ``--mode parity --nranks N`` runs the reference's
pserver/pclient protocol, every 244 MB flat message on the card through
the KV copy kernel. AlexNet computes in bf16 with float32 parameters;
``--image-size`` and ``--num-classes`` shrink the workload for tests.

    python -m mpit_tpu_torch.asyncsgd imagenet --steps 30 --batch-size 128
    python -m mpit_tpu_torch.asyncsgd imagenet --mesh data=4 --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd imagenet --mode parity --nranks 5 --steps 8
    python -m mpit_tpu_torch.asyncsgd imagenet --device cpu --steps 2 \\
        --batch-size 4 --image-size 64 --num-classes 8 --eval-batch 4

Data is the synthetic ImageNet stream (prototype plus noise), bit for
bit the JAX package's, or the npy directory of ``--data-dir``, whose
classes and image size replace the flags'.
"""

from __future__ import annotations

import dataclasses

from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import synthetic_imagenet
from mpit_tpu_torch.models import AlexNet
from mpit_tpu_torch.serve.engine import resolve_device

__all__ = ["ImagenetConfig", "main"]


@dataclasses.dataclass
class ImagenetConfig(TrainConfig):
    image_size: int = 224
    num_classes: int = 1000
    lr: float = 0.01


def main(argv: list[str] | None = None, *, initial_params=None, **overrides) -> dict:
    """Train AlexNet as the flags say. ``initial_params`` (a
    ``state_dict``) replaces the seeded initialisation; ``overrides``
    replace flag values."""
    cfg = from_argv(ImagenetConfig, argv, prog="asyncsgd.imagenet", overrides=overrides,
                    later=runner.LATER_FLAGS)
    runner.reject_later_slices(cfg)
    runner.refuse_elastic(cfg, "imagenet")
    runner.refuse_dense(cfg, stateful=False)
    resolve_device(cfg.device)  # fail before the dataset is built
    print(runner.describe(cfg, "imagenet-alexnet"))
    dataset = runner.classification_dataset(
        cfg,
        lambda: synthetic_imagenet(
            image_size=cfg.image_size, num_classes=cfg.num_classes, seed=cfg.seed
        ),
    )
    if cfg.data_dir:  # the geometry comes from the directory, not the flags
        cfg = dataclasses.replace(
            cfg, num_classes=dataset.num_classes, image_size=dataset.image_shape[0]
        )

    def make_model(**kw):
        return AlexNet(num_classes=cfg.num_classes, image_size=cfg.image_size, **kw)

    return runner.run_classifier(cfg, make_model, dataset, initial_params=initial_params,
                                 top5=cfg.num_classes > 5)


if __name__ == "__main__":
    print(main())
