"""Ulysses sequence parallelism: the all-to-all head↔sequence re-shard,
the port of :mod:`mpit_tpu.parallel.ulysses` (DeepSpeed-Ulysses,
arXiv:2309.14509).

Activations arrive sequence-sharded, rank-stacked ``[S, B, T/S, H, D]``.
One all-to-all (:func:`~mpit_tpu_torch.comm.collectives.all_to_all`, a
reshape and a transpose of the rank dimension) re-shards them to ``[S,
B, T, H/S, D]``: each rank sees the whole sequence for its ``H/S``
heads, so exact attention runs unchanged on every rank; a second
all-to-all restores the sequence shards. The ranks' ``inner`` calls are
one call over ``S·B`` rows (attention is independent over the batch):
under ``--flash true`` one launch of each flash kernel at ``H/S`` heads
and the whole T.
"""

from __future__ import annotations

from typing import Callable

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.models.gpt2 import default_attention

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, *, causal: bool = True, inner: Callable = default_attention):
    """Exact attention over the sequence the seq ranks share: q, k, v
    ``[S, B, T/S, H, D]`` in and out. ``inner(q, k, v, causal=)`` is the
    attention on the re-sharded ``[S·B, T, H/S, D]`` blocks (the flash
    kernels' seam). Heads that ``S`` does not divide raise, as in JAX."""
    s_ranks, n_heads = q.shape[0], q.shape[3]
    if n_heads % s_ranks:
        raise ValueError(
            f"Ulysses needs heads ({n_heads}) divisible by axis size ({s_ranks}); "
            "use ring_attention for head counts that don't divide"
        )
    # [S, B, T/S, H, D] -> [S, B, T, H/S, D]: split heads, join the sequence.
    to_heads = lambda x: C.all_to_all(x, split_axis=2, concat_axis=1)  # noqa: E731
    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    whole = qh.shape
    rows = lambda x: x.reshape(-1, *whole[2:])  # noqa: E731
    o = inner(rows(qh), rows(kh), rows(vh), causal=causal).reshape(whole)
    return C.all_to_all(o, split_axis=1, concat_axis=2)
