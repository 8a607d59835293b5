"""Operators of the port: the flash-decode kernel wrappers, the int8 KV
contract and the blocked decode head."""

from mpit_tpu_torch.ops.decode_attention import (
    flash_decode_attention,
    flash_paged_decode_attention,
    num_kv_blocks,
    pick_block_k,
    reference_decode_attention,
    reference_paged_decode_attention,
)
from mpit_tpu_torch.ops.kv_quant import (
    QuantizedKV,
    dequantize_kv,
    kv_wire_bytes_per_row,
    quantize_kv,
)
from mpit_tpu_torch.ops.lm_head import gumbel, lm_head_sample

__all__ = [
    "QuantizedKV",
    "dequantize_kv",
    "flash_decode_attention",
    "flash_paged_decode_attention",
    "gumbel",
    "kv_wire_bytes_per_row",
    "lm_head_sample",
    "num_kv_blocks",
    "pick_block_k",
    "quantize_kv",
    "reference_decode_attention",
    "reference_paged_decode_attention",
]
