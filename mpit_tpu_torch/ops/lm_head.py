"""Blocked decode head: sample one token per row straight from hiddens.

Streams over vocabulary blocks so the live logits tile is ``[rows,
block]`` and the ``[rows, vocab]`` logits never exist. Per block the
loop carries (1) the running argmax of the raw logits — greedy equals
``argmax`` over the full logits because the strict ``>`` merge keeps the
first maximum; (2) the running argmax of ``logit / temp + gumbel`` — an
exact full-vocabulary categorical draw by the Gumbel-max trick; (3) the
top-``k_cap`` (value, index, noised score) triples merged across blocks,
from which the top-k draw is taken without a second pass.

Plain PyTorch: a Python loop over vocabulary blocks with one matmul each.
A quantized head (:class:`~mpit_tpu_torch.ops.quantized_matmul.QuantizedTensor`)
dequantizes one vocabulary block at a time, so its only f32 view is a
``[block, d_model]`` tile.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.ops.quantized_matmul import QuantizedTensor, dequantize_tensor

__all__ = ["gumbel", "lm_head_sample"]

_NEG_BIG = -1e30  # "-inf" that survives subtraction without NaNs


def _round_up(x: int, m: int) -> int:
    return x + (-x) % m


def gumbel(shape, *, generator=None, device=None) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform in
    ``[tiny, 1)``, drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _block_logits(h, head_block, compute_dtype):
    """``[N, D] x [block, D] -> [N, block]`` f32 logits. Operands are
    rounded to ``compute_dtype`` and multiplied in f32, so the products
    are exact and the sum f32 whatever the operand dtype. A quantized
    head block is dequantized here, per block."""
    if isinstance(head_block, QuantizedTensor):
        head_block = dequantize_tensor(head_block)
    return torch.matmul(
        h.to(compute_dtype).float(), head_block.to(compute_dtype).float().T
    )


def lm_head_sample(
    h,
    head,
    temperature,
    top_k,
    *,
    generator=None,
    noise=None,
    block_size: int = 8192,
    k_cap: int = 128,
    compute_dtype=torch.float32,
):
    """Sample one token per row from ``softmax(h @ headᵀ)`` blockwise.

    ``h`` ``[N, d_model]`` hiddens, ``head`` ``[vocab, d_model]`` (plain
    or :class:`~mpit_tpu_torch.ops.quantized_matmul.QuantizedTensor`);
    ``temperature`` ``[N]`` f32 (``<= 0`` = greedy for that row) and
    ``top_k`` ``[N]`` int (``0`` = full vocabulary, else ``<= k_cap``).
    The Gumbel noise of block ``i`` (columns ``i·block`` onwards) is
    ``noise[:, i·block : (i+1)·block]`` when ``noise`` ``[N, n_blocks ·
    block]`` is given, else drawn from ``generator`` per block. The last
    block is not padded: its missing columns would score ``-1e30`` and
    could win nothing. Returns ``[N]`` int32 token ids.
    """
    vocab, _ = head.shape
    block = min(block_size, _round_up(vocab, 128))
    n = h.shape[0]
    dev = h.device
    kb = min(k_cap, vocab)
    temp = temperature.float().clamp_min(1e-6)
    neg = torch.full((n,), float("-inf"), device=dev)
    zero_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    gv, gi, sv, si = neg, zero_i, neg, zero_i
    bv = torch.full((n, kb), _NEG_BIG, device=dev)
    bi = torch.zeros((n, kb), dtype=torch.int64, device=dev)
    bs = torch.full((n, kb), _NEG_BIG, device=dev)
    for off in range(0, vocab, block):
        logits = _block_logits(h, head[off : off + block], compute_dtype)
        width = logits.shape[1]
        # (1) greedy: strict > keeps the FIRST maximum.
        bm, bmi = logits.max(dim=-1)
        upd = bm > gv
        gv, gi = torch.where(upd, bm, gv), torch.where(upd, bmi + off, gi)
        # (2) full-vocabulary Gumbel-max on temperature-scaled logits.
        if noise is not None:
            g = noise[:, off : off + width].to(dev, torch.float32)
        else:
            g = gumbel((n, width), generator=generator, device=dev)
        scaled = logits / temp[:, None] + g
        sm, smi = scaled.max(dim=-1)
        supd = sm > sv
        sv, si = torch.where(supd, sm, sv), torch.where(supd, smi + off, si)
        # (3) running top-k candidates merged into the buffer.
        cv, ci = torch.topk(logits, min(kb, width), dim=-1)
        cs = torch.gather(scaled, 1, ci)
        allv = torch.cat([bv, cv], dim=-1)
        alli = torch.cat([bi, ci + off], dim=-1)
        alls = torch.cat([bs, cs], dim=-1)
        bv, sel = torch.topk(allv, kb, dim=-1)
        bi = torch.gather(alli, 1, sel)
        bs = torch.gather(alls, 1, sel)
    # Top-k draw: keep buffer entries >= the row's k-th largest value,
    # Gumbel-argmax the survivors.
    top_k = top_k.to(dev)
    kk = top_k.long().clamp(1, kb)
    thresh = torch.gather(bv, 1, (kk - 1)[:, None])
    kept = torch.where(bv >= thresh, bs, torch.full_like(bs, float("-inf")))
    tk_tok = torch.gather(bi, 1, kept.argmax(dim=-1, keepdim=True))[:, 0]
    sampled = torch.where(top_k > 0, tk_tok, si)
    greedy = temperature.to(dev) <= 0.0
    return torch.where(greedy, gi, sampled).int()
