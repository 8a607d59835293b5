"""Models of the port."""

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

__all__ = [
    "GPT2",
    "GPT2Config",
    "cache_update",
    "cached_attention",
    "default_attention",
    "paged_cache_update",
    "paged_cached_attention",
    "paged_gather",
]
