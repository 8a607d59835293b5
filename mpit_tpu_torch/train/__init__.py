"""Training on one rank or over a World's ranks: the step, the gradient
sync, the eval step, the drive loop, metrics, the divergence guard, and
a JAX training state carried across."""

from mpit_tpu_torch.train.convert import train_state_from_jax
from mpit_tpu_torch.train.guard import Diverged, DivergenceGuard
from mpit_tpu_torch.train.loop import hardened_loop
from mpit_tpu_torch.train.metrics import MetricLogger, Throughput
from mpit_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

__all__ = [
    "Diverged",
    "DivergenceGuard",
    "MetricLogger",
    "Throughput",
    "TrainState",
    "hardened_loop",
    "make_eval_step",
    "make_train_step",
    "train_state_from_jax",
]
