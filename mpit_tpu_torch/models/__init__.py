"""Models of the port: GPT-2, the convnets LeNet and AlexNet, and
ResNet-50 with its BatchNorm."""

from mpit_tpu_torch.models.alexnet import AlexNet
from mpit_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    cache_update,
    cached_attention,
    default_attention,
    paged_cache_update,
    paged_cached_attention,
    paged_gather,
)
from mpit_tpu_torch.models.lenet import LeNet
from mpit_tpu_torch.models.norm import BatchNorm, ScaleShiftBatchNorm
from mpit_tpu_torch.models.resnet import ResNet50

__all__ = [
    "AlexNet",
    "BatchNorm",
    "GPT2",
    "GPT2Config",
    "LeNet",
    "ResNet50",
    "ScaleShiftBatchNorm",
    "cache_update",
    "cached_attention",
    "default_attention",
    "paged_cache_update",
    "paged_cached_attention",
    "paged_gather",
]
