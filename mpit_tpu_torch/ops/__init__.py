"""Operators of the port: the flash-decode kernel wrapper and the
blocked decode head."""

from mpit_tpu_torch.ops.decode_attention import (
    flash_decode_attention,
    num_kv_blocks,
    pick_block_k,
    reference_decode_attention,
)
from mpit_tpu_torch.ops.lm_head import gumbel, lm_head_sample

__all__ = [
    "flash_decode_attention",
    "gumbel",
    "lm_head_sample",
    "num_kv_blocks",
    "pick_block_k",
    "reference_decode_attention",
]
