"""Data streams of the port, and the split of a global batch over a
World's ranks."""

from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM", "shard_batch"]
