"""Quantized int8 KV storage: int8 rows plus one f32 scale per (row, head).

The rounding is :mod:`mpit_tpu_torch.ops.ring_collectives`' contract,
the one :mod:`mpit_tpu.ops.kv_quant` uses, so the port stores the very
bytes the JAX package stores. A row is quantized once, when it is
written, and never rescaled by a later append. For a paged pool the
scale block of page ``p`` is ``scale[p, :, h]``: it rides with the page
through every copy and block-table indirection that moves the int8 rows.
"""

from __future__ import annotations

import dataclasses

import torch

from mpit_tpu_torch.ops.ring_collectives import dequantize_blocks, quantize_blocks

__all__ = [
    "QuantizedKV",
    "dequantize_kv",
    "kv_tensors",
    "kv_wire_bytes_per_row",
    "quantize_kv",
]

# f32 scale per (row, head): the storage grain's fixed overhead.
SCALE_BYTES = 4


@dataclasses.dataclass
class QuantizedKV:
    """One quantized K (or V) buffer: ``q`` int8 ``[..., H, Dh]`` and
    ``scale`` f32 ``[..., H, 1]`` (keepdims, so both share rank).
    ``shape``/``dtype`` are the int8 payload's; indexing reads and
    writes both tensors together."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def __getitem__(self, idx) -> "QuantizedKV":
        return QuantizedKV(q=self.q[idx], scale=self.scale[idx])

    def __setitem__(self, idx, value: "QuantizedKV") -> None:
        self.q[idx] = value.q
        self.scale[idx] = value.scale


def quantize_kv(x) -> QuantizedKV:
    """Quantize K/V rows ``[..., H, Dh]``: one scale per ``Dh`` slice."""
    q, scale = quantize_blocks(x, dim=-1)
    return QuantizedKV(q=q, scale=scale)


def dequantize_kv(kv: QuantizedKV) -> torch.Tensor:
    """The f32 view of a quantized buffer (the plain path; the kernel
    dequantizes the rows it visits, never a whole buffer)."""
    return dequantize_blocks(kv.q, kv.scale)


def kv_tensors(buf) -> tuple:
    """The tensors that make up one K (or V) buffer: itself, or the int8
    payload and its scales."""
    return (buf.q, buf.scale) if isinstance(buf, QuantizedKV) else (buf,)


def kv_wire_bytes_per_row(num_heads: int, head_dim: int, dtype) -> float:
    """Bytes one cached K (or V) row occupies: int8 payload plus one f32
    scale per head for ``"int8"`` / ``torch.int8``, else the row in
    ``dtype``."""
    if dtype in ("int8", torch.int8):
        return float(num_heads * (head_dim + SCALE_BYTES))
    return float(num_heads * head_dim * dtype.itemsize)
