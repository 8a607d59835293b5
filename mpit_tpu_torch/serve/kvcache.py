"""The dense per-slot KV cache of the serving engine."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["KVCache", "alloc_cache"]


@dataclasses.dataclass
class KVCache:
    """The engine's decode state: KV buffers + per-slot fill counts.

    ``k``/``v``: ``[num_layers, slots, max_len, heads, head_dim]``;
    ``lengths``: ``[slots]`` int32, tokens currently cached per slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def alloc_cache(cfg, slots: int, max_len: int, *, device) -> KVCache:
    """The zeroed cache for ``slots`` concurrent requests, in
    ``cfg.dtype`` (the dtype the blocks' K/V arrive in) on ``device``. Zeroed, not empty: rows a kernel tile reads past a
    slot's fill are masked to weight 0, and ``0 * NaN`` would still
    poison the sum."""
    shape = (cfg.num_layers, slots, max_len, cfg.num_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
    )
