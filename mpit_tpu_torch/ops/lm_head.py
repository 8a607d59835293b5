"""The LM head, blocked over the vocabulary: the decode head that samples
one token per row straight from hiddens, and the training head's fused
cross entropy (:func:`lm_head_xent`).

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

__all__ = ["gumbel", "gumbel_columns", "lm_head_sample", "lm_head_verify", "lm_head_xent"]

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


def gumbel_columns(noise, off, width, n, generator, device):
    """Gumbel noise ``[n, width]``: columns ``off..off+width`` of
    ``noise`` when given, else a draw from ``generator``."""
    if noise is not None:
        return noise[:, off : off + width].to(device, torch.float32)
    return gumbel((n, width), generator=generator, device=device)


def lm_head_verify(
    h,
    head,
    drafted,
    qprobs,
    temperature,
    top_k,
    *,
    generator=None,
    noise=None,
    buffer_noise=None,
    block_size: int = 8192,
    k_cap: int = 128,
    compute_dtype=torch.float32,
):
    """Per-row verify quantities for exact speculative sampling, blocked
    over the vocabulary: the port of ``mpit_tpu.ops.lm_head.lm_head_verify``
    (a ``lax`` op there too, never Pallas).

    ``h`` ``[N, d_model]`` hidden rows (one per slot × verify position),
    ``head`` ``[vocab, d_model]`` (plain or quantized), ``drafted``
    ``[N]`` the token each row scored (any value on bonus rows),
    ``qprobs`` ``[N, vocab]`` the draft's probabilities (zeros on bonus
    rows), ``temperature`` / ``top_k`` ``[N]`` with
    :func:`lm_head_sample`'s semantics. Pass A streams the blocks for
    the greedy argmax (strict ``>`` keeps the first maximum), the
    full-support logsumexp of ``logits / temp``, the drafted token's
    logit and the top-``k_cap`` candidate buffer; pass B, only when a row
    samples the full vocabulary, draws the residual ``norm(max(p − q,
    0))`` block by block by Gumbel-argmax. The top-k residual lives in
    the buffer and needs no second pass.

    Noise: block ``b``'s Gumbel draw is columns ``b·block`` onwards of
    ``noise`` ``[N, n_blocks·block]`` and the buffer's is
    ``buffer_noise`` ``[N, min(k_cap, vocab)]`` (the JAX package's
    ``gumbel(fold_in(key, b), (N, block))`` and ``fold_in(key,
    n_blocks)`` draws, handed over by the tests); else ``generator``
    draws the buffer's first, then each block's in pass B — the contract
    of :func:`mpit_tpu_torch.serve.spec.verify_reference`, to which this
    is bitwise equal at one block. Returns ``(greedy [N] int32, p_x [N]
    f32, repl [N] int32)``."""
    vocab, _ = head.shape
    block = min(block_size, _round_up(vocab, 128))
    n = h.shape[0]
    dev = h.device
    kb = min(k_cap, vocab)
    temperature = temperature.float().to(dev)
    top_k = top_k.to(dev)
    temp = temperature.clamp_min(1e-6)
    drafted = drafted.long().to(dev)
    neg = torch.full((n,), float("-inf"), device=dev)
    zero_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    gv, gi, m = neg, zero_i, neg
    s = torch.zeros((n,), device=dev)
    tl = torch.full((n,), _NEG_BIG, device=dev)
    bv = torch.full((n, kb), _NEG_BIG, device=dev)
    bi = torch.zeros((n, kb), dtype=torch.int64, device=dev)
    for off in range(0, vocab, block):
        logits = _block_logits(h, head[off : off + block], compute_dtype)
        width = logits.shape[1]
        bm, bmi = logits.max(dim=-1)
        upd = bm > gv
        gv, gi = torch.where(upd, bm, gv), torch.where(upd, bmi + off, gi)
        scaled = logits / temp[:, None]
        m_new = torch.maximum(m, scaled.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(scaled - m_new[:, None]).sum(-1)
        m = m_new
        lt = drafted - off
        in_blk = (lt >= 0) & (lt < width)
        cand = logits.gather(1, lt.clamp(0, width - 1)[:, None])[:, 0]
        tl = torch.where(in_blk, cand, tl)
        cv, ci = torch.topk(logits, min(kb, width), dim=-1)
        bv, sel = torch.topk(torch.cat([bv, cv], dim=-1), kb, dim=-1)
        bi = torch.gather(torch.cat([bi, ci + off], dim=-1), 1, sel)
    lse_full = m + torch.log(s)
    kk = top_k.long().clamp(1, kb)
    thresh = bv.gather(1, (kk - 1)[:, None])[:, 0]
    keep = bv >= thresh[:, None]
    sc_b = bv / temp[:, None]
    m_b = torch.where(keep, sc_b, float("-inf")).amax(dim=1)
    lse_topk = m_b + torch.log(
        torch.where(keep, torch.exp(sc_b - m_b[:, None]), 0.0).sum(dim=1)
    )
    p_x = torch.where(
        top_k > 0,
        torch.where(tl >= thresh, torch.exp(tl / temp - lse_topk), 0.0),
        torch.exp(tl / temp - lse_full),
    )
    q_b = qprobs.to(dev).gather(1, bi)
    p_b = torch.where(keep, torch.exp(sc_b - lse_topk[:, None]), 0.0)
    res_b = torch.clamp_min(p_b - q_b, 0.0)
    g_b = gumbel_columns(buffer_noise, 0, kb, n, generator, dev)
    buf_tok = bi.gather(1, (torch.log(res_b) + g_b).argmax(dim=1)[:, None])[:, 0]
    full_tok = zero_i
    if bool(((top_k == 0) & (temperature > 0.0)).any()):
        best = neg
        for off in range(0, vocab, block):
            logits = _block_logits(h, head[off : off + block], compute_dtype)
            width = logits.shape[1]
            p = torch.exp(logits / temp[:, None] - lse_full[:, None])
            res = torch.clamp_min(p - qprobs[:, off : off + width].to(dev), 0.0)
            score = torch.log(res) + gumbel_columns(noise, off, width, n, generator, dev)
            sm, smi = score.max(dim=-1)
            upd = sm > best
            best = torch.where(upd, sm, best)
            full_tok = torch.where(upd, smi + off, full_tok)
    repl = torch.where(top_k > 0, buf_tok, full_tok).int()
    return gi.int(), p_x, repl


def _mm_f32(a, b, compute_dtype):
    """``a @ b`` ``[N, K] x [K, M]`` with both operands rounded to
    ``compute_dtype`` and an f32 result: JAX's ``preferred_element_type
    = f32``, which keeps every product exact and sums in f32. A bf16 x
    bf16 ``torch.matmul`` rounds its result to bf16, another function; so
    on the card bf16 operands go through cuBLAS with an f32 output
    (``out_dtype``), and elsewhere they are multiplied as f32, which is
    exact for bf16 values."""
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if compute_dtype != torch.float32 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _BlockedXent(torch.autograd.Function):
    """Per-token ``logsumexp(h @ headᵀ) - (h @ headᵀ)[target]`` over
    vocabulary blocks with an online logsumexp: the live logits tile is
    ``[N, block]`` and the ``[N, vocab]`` logits never exist. The
    backward recomputes each block's logits and feeds
    ``g = (softmax - onehot) · ct`` (rounded to ``compute_dtype``) to the
    two products ``dh += g @ head_blk`` and ``dhead_blk = gᵀ @ h``; the
    per-token lse is the only saved activation."""

    @staticmethod
    def forward(ctx, h, head, targets, block, compute_dtype):
        n = h.shape[0]
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros((n,), device=h.device)
        tl = torch.zeros((n,), device=h.device)
        for off in range(0, head.shape[0], block):
            logits = _mm_f32(h, head[off : off + block].T, compute_dtype)
            width = logits.shape[1]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            lt = targets - off
            in_blk = (lt >= 0) & (lt < width)
            cand = logits.gather(1, lt.clamp(0, width - 1)[:, None])[:, 0]
            tl = torch.where(in_blk, cand, tl)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, head, targets, lse)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return lse - tl

    @staticmethod
    def backward(ctx, ct):
        h, head, targets, lse = ctx.saved_tensors
        block, cd = ctx.block, ctx.compute_dtype
        rows = torch.arange(h.shape[0], device=h.device)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dhead = torch.empty(head.shape, dtype=torch.float32, device=head.device)
        for off in range(0, head.shape[0], block):
            head_b = head[off : off + block]
            g = torch.exp(_mm_f32(h, head_b.T, cd) - lse[:, None])
            width = g.shape[1]
            lt = targets - off
            in_blk = (lt >= 0) & (lt < width)
            g[rows[in_blk], lt[in_blk]] -= 1.0
            g = (g * ct[:, None]).to(cd)
            dh += _mm_f32(g, head_b, cd)
            dhead[off : off + block] = _mm_f32(g.T, h, cd)
        return dh.to(h.dtype), dhead.to(head.dtype), None, None, None


def lm_head_xent(h, head, targets, *, block_size: int = 8192, compute_dtype=torch.bfloat16):
    """Per-token cross entropy ``-log p(target)`` straight from hiddens.

    ``h`` ``[..., d_model]`` final hidden states (any float dtype),
    ``head`` ``[vocab, d_model]`` (the LM-head or tied embedding weight),
    ``targets`` ``[...]`` integer ids. ``block_size`` is the vocabulary
    tile; ``compute_dtype`` the products' operand dtype (f32 results
    regardless: ``bfloat16`` is the training default, ``float32`` gives
    the materialized-logits numbers). Returns ``[...]`` f32 losses;
    callers reduce. Plain PyTorch: the JAX package never wrote this head
    in Pallas either. The last block is not padded: its missing columns
    would carry ``exp(-1e30) = 0`` and match no target."""
    if isinstance(head, QuantizedTensor):
        raise ValueError(
            "lm_head_xent is the training head; the int8 weight store is a "
            "serving format with no gradient"
        )
    vocab, d = head.shape
    block = min(block_size, _round_up(vocab, 128))
    lead = targets.shape
    loss = _BlockedXent.apply(
        h.reshape(-1, d), head, targets.reshape(-1).long(), block, compute_dtype
    )
    return loss.reshape(lead)
