"""Operators of the port: the flash-decode kernel wrappers, the int8 KV
contract, the int8 weight store with its fused-dequant matmul, and the
blocked decode head.

The serving matmul itself is imported from its module,
``mpit_tpu_torch.ops.quantized_matmul.quantized_matmul``: exported here
under the module's own name, the function would hide the module (and
its ``launches`` count) from ``from mpit_tpu_torch.ops import
quantized_matmul``."""

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
from mpit_tpu_torch.ops.quantized_matmul import (
    QuantizedTensor,
    dequantize_tensor,
    quantize_tensor,
    quantized_matmul_plain,
    quantized_matmul_reference,
    quantized_matmul_t,
    weight_wire_bytes,
)

__all__ = [
    "QuantizedKV",
    "QuantizedTensor",
    "dequantize_kv",
    "dequantize_tensor",
    "flash_decode_attention",
    "flash_paged_decode_attention",
    "gumbel",
    "kv_wire_bytes_per_row",
    "lm_head_sample",
    "num_kv_blocks",
    "pick_block_k",
    "quantize_kv",
    "quantize_tensor",
    "quantized_matmul_plain",
    "quantized_matmul_reference",
    "quantized_matmul_t",
    "reference_decode_attention",
    "reference_paged_decode_attention",
    "weight_wire_bytes",
]
