"""Models of the port: GPT-2, and the convnets LeNet and AlexNet."""

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

__all__ = [
    "AlexNet",
    "GPT2",
    "GPT2Config",
    "LeNet",
    "cache_update",
    "cached_attention",
    "default_attention",
    "paged_cache_update",
    "paged_cached_attention",
    "paged_gather",
]
