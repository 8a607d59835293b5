"""Context parallelism: ring attention over the ``seq`` ranks, the port of
:mod:`mpit_tpu.parallel.ring_attention` (Liu et al., Ring Attention with
Blockwise Transformers, arXiv:2310.01889).

The JAX functions run inside ``shard_map`` and see one device's
``[B, T/S, H, D]`` block of q, k and v; K/V hop one device a ring step
(``lax.ppermute``). The port's take every seq rank's block at once,
rank-stacked ``[S, B, T/S, H, D]``, and the hop is an index operation on
the rank dimension (:func:`~mpit_tpu_torch.comm.collectives.shift`): at
ring step ``s`` rank ``r`` holds the K/V block of rank ``src = (r - s)
mod S``, its queries at global rows ``r·T/S ..`` and its keys at
``src·T/S ..``.

- :func:`ring_attention` — the blockwise online-softmax triple
  ``(o, l, m)`` in f32, plain PyTorch, every rank's block in one batched
  product a step. A wholly-future block still goes through the
  accumulator masked to ``-2^30`` (JAX keeps the step count static); the
  rescale zeroes it.
- :func:`ring_flash_attention` — each step through the flash kernels'
  offset-aware block (:func:`~mpit_tpu_torch.ops.flash_attention.flash_attention_block`,
  the CUDA kernels on the card, their plain versions on the CPU), the
  partials folded by :func:`~mpit_tpu_torch.ops.flash_attention.merge_attention`
  into an f32 accumulator seeded with ``(0, -1e30)``. The kernels' lse
  cotangent carries the merge's gradient back (it folds into delta).

Causal masking reads only the offsets' difference (``q_off + i >= k_off
+ j``). At step ``s`` every rank ``r >= s`` holds a block ``s`` blocks in
its past (the diagonal at ``s = 0``), so those ranks' blocks are one
launch of ``(S - s)·B`` rows at offsets ``(s·T/S, 0)``: the values JAX's
per-rank calls give. The ranks ``r < s`` hold a block wholly in their
future, whose ``(o, lse)`` is ``(0, -1e30)``, the merge's neutral
element: JAX launches its kernel for it; the port does not (the merge
would leave the accumulator as it is, and its gradient is zero). Per
layer that is ``S`` launches of each kernel, not ``S²``.
"""

from __future__ import annotations

import math

import torch

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.ops.flash_attention import (
    _NEG_BIG as _FLASH_NEG,
    flash_attention_block,
    merge_attention,
)

__all__ = ["ring_attention", "ring_flash_attention"]

# Finite "minus infinity" of the plain ring (JAX's): a wholly masked
# block yields exp(0) = 1 garbage that the online rescale multiplies by
# exp(-BIG) = 0, instead of NaN from inf - inf.
_NEG_BIG = -(2.0**30)


def _check(q, k, v):
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected rank-stacked [S, B, T/S, H, D] q, k, v of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def ring_attention(q, k, v, *, causal: bool = True):
    """Exact attention over the sequence the seq ranks share: q, k, v
    ``[S, B, T/S, H, D]`` (row ``r`` rank ``r``'s block) in, the same
    out, equal to full attention on the joined sequence (the online
    softmax is exact). f32 scores ``f32(q)·f32(k) / sqrt(D)``, f32 PV
    products, one cast to q's dtype at the end, as JAX computes them."""
    _check(q, k, v)
    s_ranks, b, tl, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    idx = torch.arange(s_ranks, device=dev)
    rows = torch.arange(tl, device=dev)
    qf = q.float()
    o = torch.zeros((s_ranks, b, tl, h, d), dtype=torch.float32, device=dev)
    l = torch.zeros((s_ranks, b, h, tl), dtype=torch.float32, device=dev)
    m = torch.full((s_ranks, b, h, tl), _NEG_BIG, dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for s in range(s_ranks):
        src = (idx - s) % s_ranks  # whose K/V block each rank holds
        scores = torch.einsum("rbqhd,rbkhd->rbhqk", qf, k_blk.float()) * scale
        if causal:
            q_pos = idx[:, None] * tl + rows
            k_pos = src[:, None] * tl + rows
            allowed = q_pos[:, :, None] >= k_pos[:, None, :]  # [S, Tq, Tk]
            scores = torch.where(allowed[:, None, None], scores, _NEG_BIG)
        m_b = scores.amax(dim=-1)
        p = torch.exp(scores - m_b[..., None])
        l_b = p.sum(dim=-1)
        o_b = torch.einsum("rbhqk,rbkhd->rbqhd", p, v_blk.float())
        m_new = torch.maximum(m, m_b)
        alpha = torch.exp(m - m_new)  # the running accumulator's rescale
        beta = torch.exp(m_b - m_new)  # this block's
        l = l * alpha + l_b * beta
        o = o * alpha.transpose(2, 3)[..., None] + o_b * beta.transpose(2, 3)[..., None]
        m = m_new
        # One hop: rank i's block moves to rank i + 1.
        k_blk, v_blk = C.shift(k_blk, 1), C.shift(v_blk, 1)
    return (o / l.transpose(2, 3)[..., None]).to(q.dtype)


def ring_flash_attention(q, k, v, *, causal: bool = True):
    """:func:`ring_attention`'s contract through the flash kernels' block
    (module docstring): ``[S, B, T/S, H, D]`` in and out, the partials
    merged in f32, one cast to q's dtype at the end. Causal: ``S``
    launches of each kernel a call, step ``s`` over ranks ``s ..
    S - 1``; the wholly-future blocks of ranks below ``s`` are not
    launched. Non-causal: every rank at every step, K/V shifted."""
    _check(q, k, v)
    s_ranks, b, tl, h, d = q.shape
    rows = lambda x: x.reshape(-1, tl, h, d)  # noqa: E731 -- ranks into the batch
    # The accumulator with the ranks in its batch: row r·B + i is rank r's.
    o = torch.zeros((s_ranks * b, tl, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((s_ranks * b, h, tl), _FLASH_NEG, dtype=torch.float32, device=q.device)
    for s in range(s_ranks):
        if causal:
            # Ranks s .. S-1 hold K/V of ranks 0 .. S-1-s: blocks s back.
            o_b, lse_b = flash_attention_block(
                rows(q[s:]), rows(k[: s_ranks - s]), rows(v[: s_ranks - s]),
                q_offset=s * tl, k_offset=0, causal=True,
            )
            o_m, lse_m = merge_attention(o[s * b:], lse[s * b:], o_b, lse_b)
            o, lse = torch.cat((o[: s * b], o_m)), torch.cat((lse[: s * b], lse_m))
        else:
            k_src, v_src = C.shift(k, s), C.shift(v, s)
            o_b, lse_b = flash_attention_block(rows(q), rows(k_src), rows(v_src), causal=False)
            o, lse = merge_attention(o, lse, o_b, lse_b)
    return o.view(q.shape).to(q.dtype)
