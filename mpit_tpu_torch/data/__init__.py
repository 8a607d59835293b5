"""Data streams of the port, and the split of a global batch over a
World's ranks."""

from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    synthetic_imagenet,
    synthetic_mnist,
)

__all__ = [
    "SyntheticClassification",
    "SyntheticLM",
    "shard_batch",
    "synthetic_imagenet",
    "synthetic_mnist",
]
