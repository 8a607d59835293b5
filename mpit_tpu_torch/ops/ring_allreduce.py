"""Ring allreduce: the composition of the ring reduce-scatter and
all-gather, as :func:`mpit_tpu.ops.ring_allreduce.ring_allreduce` is.

``ring_allreduce = ring_all_gather ∘ ring_reduce_scatter`` on rank-stacked
payloads (:mod:`mpit_tpu_torch.ops.ring_collectives`): the classic
``2·(P-1)/P·N`` decomposition. ``op="qsum"`` runs the int8 wire in both
halves (lossy by design; the result is cast back to the payload's
dtype). ``p = 1`` returns the payload: it already is the sum.
"""

from __future__ import annotations

from mpit_tpu_torch.ops.ring_collectives import ring_all_gather, ring_reduce_scatter

__all__ = ["ring_allreduce"]


def ring_allreduce(xs, *, op: str = "sum"):
    """All-reduce rank-stacked payloads ``xs [p, ...]``: every rank's row
    of the result (same shape as ``xs``) holds the sum over the ranks."""
    if op not in ("sum", "qsum"):
        raise ValueError(f"op must be 'sum' or 'qsum', got {op!r}")
    p = xs.shape[0]
    if p == 1:
        return xs
    flat = xs.reshape(p, -1)
    shard = ring_reduce_scatter(flat, op=op)
    full = ring_all_gather(shard.to(xs.dtype), quantized=op == "qsum", out_size=flat.shape[1])
    return full.reshape(xs.shape)
