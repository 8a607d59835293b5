"""The split of a global batch over a World's ranks: the port of
:func:`mpit_tpu.data.loader.shard_batch`.

Rank ``r`` of ``p`` takes rows ``[r·B/p, (r+1)·B/p)`` of every leaf, on
its device: the single-controller analogue of each worker rank loading
its own partition. The batch dimension must divide by ``p``, as the JAX
package requires.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["shard_batch"]


def shard_batch(world, batch: Mapping, *, axis: str = "data") -> list[dict]:
    """``batch`` (a mapping of numpy arrays or tensors, leading dim the
    global batch) as a list of ``p`` per-rank mappings, rank ``r``'s
    slices on ``world.rank_device(r)`` (views when they already lie
    there)."""
    p = world.axis_size(axis)
    out: list[dict] = [{} for _ in range(p)]
    for name, x in batch.items():
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if x.dim() == 0:
            raise ValueError(f"batch leaf {name!r} has no batch dimension")
        if x.shape[0] % p:
            raise ValueError(
                f"batch dim 0 ({x.shape[0]}) not divisible by ('{axis}',)={p}"
            )
        for r, part in enumerate(torch.chunk(x, p, dim=0)):
            out[r][name] = part.to(world.rank_device(r), non_blocking=True)
    return out
