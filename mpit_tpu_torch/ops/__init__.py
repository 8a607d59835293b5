"""Operators of the port: the flash-decode kernel wrappers, the int8 KV
contract, the int8 weight store with its fused-dequant matmul, the
blocked LM head (decode sampler and training cross entropy), the
training flash attention, the ring reduce-scatter / all-gather of
the gradient sync (``mpit_tpu_torch.ops.ring_collectives``,
``mpit_tpu_torch.ops.ring_allreduce``), and the byte copy that carries
the fleet's KV shipments on the card (``mpit_tpu_torch.ops.kv_ship``).

The serving matmul and the training attention are imported from their
modules, ``mpit_tpu_torch.ops.quantized_matmul.quantized_matmul`` and
``mpit_tpu_torch.ops.flash_attention.flash_attention``: exported here
under their modules' own names, the functions would hide the modules
(and their ``launches`` counts) from ``from mpit_tpu_torch.ops import
quantized_matmul``."""

from mpit_tpu_torch.ops.decode_attention import (
    flash_decode_attention,
    flash_paged_decode_attention,
    num_kv_blocks,
    pick_block_k,
    reference_decode_attention,
    reference_paged_decode_attention,
)
from mpit_tpu_torch.ops.flash_attention import (
    flash_attention_block,
    merge_attention,
    reference_attention,
    reference_attention_with_lse,
)
from mpit_tpu_torch.ops.kv_quant import (
    QuantizedKV,
    dequantize_kv,
    kv_wire_bytes_per_row,
    quantize_kv,
)
from mpit_tpu_torch.ops.lm_head import gumbel, lm_head_sample, lm_head_xent
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
    "flash_attention_block",
    "flash_decode_attention",
    "flash_paged_decode_attention",
    "gumbel",
    "kv_wire_bytes_per_row",
    "lm_head_sample",
    "lm_head_xent",
    "merge_attention",
    "num_kv_blocks",
    "pick_block_k",
    "quantize_kv",
    "quantize_tensor",
    "quantized_matmul_plain",
    "quantized_matmul_reference",
    "quantized_matmul_t",
    "reference_attention",
    "reference_attention_with_lse",
    "reference_decode_attention",
    "reference_paged_decode_attention",
    "weight_wire_bytes",
]
