"""The split of a global batch over a World's ranks: the port of
:func:`mpit_tpu.data.loader.shard_batch`.

Rank ``r`` of ``p`` takes rows ``[r·B/p, (r+1)·B/p)`` of every leaf, on
its device: the single-controller analogue of each worker rank loading
its own partition. The batch dimension must divide by ``p``, as the JAX
package requires. With ``seq_axis`` (JAX's ``spec=P("data", "seq")``,
the context-parallel tier's split) each data rank's rows are also cut
along the sequence over the seq ranks, rank-stacked ``[S, B/p, T/S]``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["shard_batch"]


def shard_batch(world, batch: Mapping, *, axis: str = "data",
                seq_axis: str | None = None) -> list[dict]:
    """``batch`` (a mapping of numpy arrays or tensors, leading dim the
    global batch) as a list of ``p`` per-rank mappings, rank ``r``'s
    slices on ``world.rank_device(r)`` (views when they already lie
    there). A World without ``axis`` has one rank on it. ``seq_axis``:
    each slice ``[B/p, T, ...]`` also cut into the seq ranks' ``[S,
    B/p, T/S, ...]`` (T must divide by S)."""
    p = world.size(axis)
    n_seq = world.axis_size(seq_axis) if seq_axis else 1
    out: list[dict] = [{} for _ in range(p)]
    for name, x in batch.items():
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if x.dim() == 0:
            raise ValueError(f"batch leaf {name!r} has no batch dimension")
        if x.shape[0] % p:
            raise ValueError(
                f"batch dim 0 ({x.shape[0]}) not divisible by ('{axis}',)={p}"
            )
        if seq_axis and (x.dim() < 2 or x.shape[1] % n_seq):
            raise ValueError(
                f"batch leaf {name!r} {tuple(x.shape)}: dim 1 not divisible by "
                f"('{seq_axis}',)={n_seq}"
            )
        for r, part in enumerate(torch.chunk(x, p, dim=0)):
            if seq_axis:
                part = part.unflatten(1, (n_seq, -1)).transpose(0, 1)
            out[r][name] = part.to(world.rank_device(r), non_blocking=True)
    return out
