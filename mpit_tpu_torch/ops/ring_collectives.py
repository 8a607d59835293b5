"""The int8 rounding contract shared with :mod:`mpit_tpu.ops.ring_collectives`.

Only the quantization half of that module so far: one scale per block,
``amax / 127`` in f32 (1.0 for an all-zero block, so dequantizing it is
exact), ``round(x / scale)`` half to even (``torch.round`` rounds half
to even, as ``jnp.round`` does), clipped to ±127. The expressions are
evaluated in the JAX package's order, so the int8 payloads and scales
are bit-identical to its. The ring kernels themselves join this module
in the ring-collectives slice.
"""

from __future__ import annotations

import torch

__all__ = ["dequantize_blocks", "quantize_blocks"]


def _q8_scale(amax):
    """The one scale rule: ``amax / 127`` in f32, 1.0 where amax is 0."""
    return torch.where(amax > 0, amax / 127.0, 1.0).float()


def _q8_round(x, scale):
    """The one rounding rule: half to even, clipped to ±127, as int8."""
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)


def quantize_blocks(x, dim: int = -1):
    """One scale per slice along ``dim``: returns ``(q int8 like x,
    scale f32 with dim kept at size 1)``."""
    x = x.float()
    scale = _q8_scale(x.abs().amax(dim=dim, keepdim=True))
    return _q8_round(x, scale), scale


def dequantize_blocks(q, scale):
    """Inverse of :func:`quantize_blocks` (f32; ``scale`` broadcasts)."""
    return q.float() * scale
