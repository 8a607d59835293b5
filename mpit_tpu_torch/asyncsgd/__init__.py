"""The port's training workloads (the application layer of
:mod:`mpit_tpu.asyncsgd`): ``mnist`` (LeNet, configs #1 and #2),
``imagenet`` (AlexNet, config #3) and ``gpt2``, on one rank or over
``--mesh data=N`` ranks, and for the convnets mpiT's pserver/pclient
protocol (``--mode parity``); the parity actors, the shared run harness
and the config/flag system.

    python -m mpit_tpu_torch.asyncsgd mnist --steps 30 --batch-size 32
    python -m mpit_tpu_torch.asyncsgd mnist --mode parity --nranks 5 --easgd true
    python -m mpit_tpu_torch.asyncsgd imagenet --mesh data=4 --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4 --grad-sync ring
"""

from mpit_tpu_torch.asyncsgd.actors import PClient, pserver, run_parameter_server
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv

WORKLOADS = ("mnist", "imagenet", "gpt2")
# Workloads of the JAX package that a later slice of the port brings.
LATER_WORKLOADS = {
    "resnet": "the ResNet slice of the port (ResNet-50, the stateful step; ROADMAP.md §A 3b)",
}

__all__ = [
    "LATER_WORKLOADS",
    "PClient",
    "TrainConfig",
    "WORKLOADS",
    "from_argv",
    "pserver",
    "run_parameter_server",
]
