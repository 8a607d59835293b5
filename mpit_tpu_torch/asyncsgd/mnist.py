"""MNIST LeNet: baseline configs #1 and #2, on the GPU. The port of
:mod:`mpit_tpu.asyncsgd.mnist`.

Both shapes of the reference run from this one script:

- ``--mode spmd`` (the default): the collapsed step, on one rank or
  over ``--mesh data=N`` ranks (config #2's four clients are ``--mesh
  data=4``; ``--grad-sync ring|ring_q8`` syncs through the ring kernels);
- ``--mode parity --nranks 2`` / ``--nranks 5``: the reference-shaped
  1 server + N clients protocol on the compat simulator (Downpour, or
  ``--easgd true`` for elastic averaging), every message on the card;
- ``--mode elastic --nranks N``: the elastic EASGD tier, 1 anchor server
  + N - 1 replicas with heartbeats, leases, quarantine and (with
  ``--ckpt-dir``) crash and rejoin from per-replica checkpoints.

    python -m mpit_tpu_torch.asyncsgd mnist --steps 30 --batch-size 32
    python -m mpit_tpu_torch.asyncsgd mnist --mesh data=4 --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd mnist --mode parity --nranks 5 --easgd true
    python -m mpit_tpu_torch.asyncsgd mnist --mode elastic --nranks 5 --steps 240 \\
        --batch-size 128 --sync-every 4 --easgd-beta 0.5 --ckpt-dir runs/fleet --ckpt-every 10
    python -m mpit_tpu_torch.asyncsgd mnist --device cpu --steps 30 --batch-size 32

Data is the synthetic MNIST stream (28×28×1, 10 classes, prototype plus
noise), bit for bit the JAX package's, or a 28×28×1 npy directory
(``--data-dir``).
"""

from __future__ import annotations

from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import synthetic_mnist
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.serve.engine import resolve_device

__all__ = ["main"]


def main(argv: list[str] | None = None, *, initial_params=None, **overrides) -> dict:
    """Train LeNet as the flags say. ``initial_params`` (a ``state_dict``,
    e.g. :func:`mpit_tpu_torch.models.layers.params_from_jax` of the JAX
    package's ``model.init``) replaces the seeded initialisation;
    ``overrides`` replace flag values, and ``fault_plan`` (not a flag) is
    the :class:`~mpit_tpu_torch.compat.FaultPlan` of ``--mode elastic``."""
    fault_plan = overrides.pop("fault_plan", None)
    cfg = from_argv(TrainConfig, argv, prog="asyncsgd.mnist", overrides=overrides,
                    later=runner.LATER_FLAGS)
    runner.reject_later_slices(cfg)
    runner.refuse_dense(cfg, stateful=False)
    resolve_device(cfg.device)  # fail before the dataset is built
    print(runner.describe(cfg, "mnist-lenet"))
    dataset = runner.classification_dataset(cfg, lambda: synthetic_mnist(seed=cfg.seed))
    if cfg.data_dir and dataset.image_shape != (28, 28, 1):
        raise SystemExit(
            f"mnist: --data-dir images are {dataset.image_shape}, LeNet expects (28, 28, 1)"
        )

    def make_model(**kw):
        return LeNet(num_classes=dataset.num_classes, **kw)

    return runner.run_classifier(cfg, make_model, dataset, initial_params=initial_params,
                                 fault_plan=fault_plan)


if __name__ == "__main__":
    print(main())
