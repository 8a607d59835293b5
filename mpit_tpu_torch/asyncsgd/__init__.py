"""The port's training workloads (the application layer of
:mod:`mpit_tpu.asyncsgd`): ``gpt2`` on one rank or over ``--mesh
data=N`` ranks, the shared run harness and the config/flag system.

    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true
    python -m mpit_tpu_torch.asyncsgd gpt2 --flash true --mesh data=4 --grad-sync ring
"""

from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv

WORKLOADS = ("gpt2",)
# Workloads of the JAX package that a later slice of the port brings.
LATER_WORKLOADS = {
    "mnist": "the convnet-training slice (LeNet, AlexNet, ResNet)",
    "imagenet": "the convnet-training slice (LeNet, AlexNet, ResNet)",
    "resnet": "the convnet-training slice (LeNet, AlexNet, ResNet)",
}

__all__ = ["LATER_WORKLOADS", "TrainConfig", "WORKLOADS", "from_argv"]
