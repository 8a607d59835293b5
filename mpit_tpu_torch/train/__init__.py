"""Training on one rank or over a World's ranks: the step, the gradient
sync, the eval step, the drive loop, metrics, the divergence guard,
checkpoints, the dense cross-geometry format, the elastic EASGD tier,
and a JAX training state carried across."""

from mpit_tpu_torch.train.checkpoint import AtomicCheckpoint, CheckpointManager
from mpit_tpu_torch.train.convert import (
    DenseState,
    dense_from_dp,
    dp_from_dense,
    load_dense,
    save_dense,
    train_state_from_jax,
)
from mpit_tpu_torch.train.elastic import AnchorTimeoutError, ElasticConfig, run_elastic
from mpit_tpu_torch.train.guard import Diverged, DivergenceGuard
from mpit_tpu_torch.train.loop import hardened_loop
from mpit_tpu_torch.train.metrics import MetricLogger, Throughput
from mpit_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

__all__ = [
    "AnchorTimeoutError",
    "AtomicCheckpoint",
    "CheckpointManager",
    "DenseState",
    "Diverged",
    "DivergenceGuard",
    "ElasticConfig",
    "MetricLogger",
    "Throughput",
    "TrainState",
    "dense_from_dp",
    "dp_from_dense",
    "hardened_loop",
    "load_dense",
    "make_eval_step",
    "make_train_step",
    "run_elastic",
    "save_dense",
    "train_state_from_jax",
]
