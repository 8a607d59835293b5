"""The port's training workloads (the application layer of
:mod:`mpit_tpu.asyncsgd`): ``mnist`` (LeNet, configs #1 and #2),
``imagenet`` (AlexNet, config #3), ``resnet`` (ResNet-50, config #4,
through the stateful step) and ``gpt2``, on one rank or over ``--mesh
data=N`` ranks, and for LeNet and AlexNet mpiT's pserver/pclient
protocol (``--mode parity``); the parity actors, the shared run harness
and the config/flag system.

    python -m mpit_tpu_torch.asyncsgd mnist --steps 30 --batch-size 32
    python -m mpit_tpu_torch.asyncsgd mnist --mode parity --nranks 5 --easgd true
    python -m mpit_tpu_torch.asyncsgd imagenet --mesh data=4 --grad-sync ring
    python -m mpit_tpu_torch.asyncsgd resnet --mesh data=4 --zero1 true --grad-sync ring_q8
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4 --grad-sync ring
"""

from mpit_tpu_torch.asyncsgd.actors import PClient, pserver, run_parameter_server
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv

WORKLOADS = ("mnist", "imagenet", "resnet", "gpt2")

__all__ = [
    "PClient",
    "TrainConfig",
    "WORKLOADS",
    "from_argv",
    "pserver",
    "run_parameter_server",
]
