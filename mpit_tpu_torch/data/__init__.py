"""Data streams of the port."""

from mpit_tpu_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
