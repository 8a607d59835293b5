"""Speculative decoding: the pure math of draft-then-verify, the port of
:mod:`mpit_tpu.serve.spec`.

A small draft model proposes ``k`` tokens per slot, the target scores
all ``k + 1`` positions in one cache-aware forward (the flash-decode
kernel at T = k + 1), and per slot the longest verified prefix is
emitted. Cache lengths advance by the emitted count only: that is the
rollback (a row's validity comes from ``lengths`` and the attention
mask, never from the buffer's contents, dense and paged alike).

- :func:`modified_logits` — the per-slot top-k / temperature
  modification, the ONE implementation the engine's sampler
  (:func:`mpit_tpu_torch.serve.engine.sample_tokens`) and the draft's
  proposal share: rejection sampling is exact only if ``q`` is exactly
  the distribution the draft draws from;
- :func:`draft_distribution` — the proposal ``q`` and the scaled logits
  it is drawn from;
- :func:`accept_emit` — the longest accepted prefix plus the
  replacement / bonus token, clamped at EOS and at the token budget, so
  the device's lengths and the host's token lists move in lockstep;
- :func:`verify_reference` — the full-logits verifier (greedy argmax,
  the modified-target probability of each drafted token, the exact
  residual / bonus sample), which the reference engine runs and the
  blocked :func:`mpit_tpu_torch.ops.lm_head.lm_head_verify` is held to.

Greedy speculation accepts a drafted token iff it equals the target's
argmax, so the emitted sequence is the plain greedy one. Sampling is
exact rejection sampling (Leviathan et al., arXiv 2211.17192): accept
``x ~ q`` when ``u·q(x) < p(x)``, on a rejection draw from
``norm(max(p − q, 0))``; the bonus token (all ``k`` accepted) is the
same formula with ``q = 0``, a plain target sample.

:func:`register_draft_store` puts the draft's device bytes in the
engine's memory ledger.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.ops.lm_head import gumbel_columns

__all__ = [
    "accept_emit",
    "draft_distribution",
    "modified_logits",
    "register_draft_store",
    "verify_reference",
]


def register_draft_store(
    memledger, draft_params, *, target_params=None, kv_bytes: float = 0.0
) -> float:
    """Register a speculative engine's draft with the memory ledger:
    its weights under ``draft_weights`` (only the tensors that do not
    share storage with ``target_params``:
    :func:`~mpit_tpu_torch.serve.weights.register_param_store`) and its
    cache tensors (``kv_bytes``) on the ``kv_pool`` line. The port's
    draft model loads its own copy of every leaf, even of the leaves a
    :func:`~mpit_tpu_torch.serve.weights.draft_from_target` draft shares
    with the target in the JAX package, so its weights are real bytes
    here. Returns the granted weight bytes; ``memledger=None`` does
    nothing."""
    if memledger is None:
        return 0.0
    from mpit_tpu_torch.serve.weights import register_param_store

    granted = register_param_store(
        memledger, draft_params, subsystem="draft_weights", alias_of=target_params
    )
    if kv_bytes:
        memledger.grant("kv_pool", float(kv_bytes), kind="draft_kv")
    return granted


def modified_logits(logits, temperature, top_k):
    """Per slot: threshold at the k-th largest logit when ``top_k > 0``,
    then divide by ``max(temperature, 1e-6)``. ``logits`` ``[S, V]``."""
    vocab = logits.shape[-1]
    sorted_desc = logits.sort(dim=-1, descending=True).values
    k_idx = (top_k.long() - 1).clamp(0, vocab - 1)
    thresh = sorted_desc.gather(1, k_idx[:, None])
    masked = logits.masked_fill((top_k[:, None] > 0) & (logits < thresh), float("-inf"))
    return masked / temperature.float().clamp_min(1e-6)[:, None]


def draft_distribution(logits, temperature, top_k):
    """The proposal ``q``: ``logits`` ``[S, V]`` f32 under the slots'
    temperature / top-k. Returns ``(probs, scaled)``: ``probs`` is q, and
    ``scaled`` the modified logits a categorical draw (Gumbel-max) takes
    its exact q sample from. Greedy rows (``temperature <= 0``) accept by
    argmax equality; their probs are computed and unused."""
    scaled = modified_logits(logits, temperature, top_k)
    return torch.softmax(scaled, dim=-1), scaled


def accept_emit(drafted, greedy, p_x, q_x, u, repl, greedy_row, budget, eos):
    """Longest-accepted-prefix emission for one verify pass (``S`` slots,
    ``k`` drafted tokens a slot).

    ``drafted`` ``[S, k]`` the proposals; ``greedy`` ``[S, k+1]`` the
    target's argmax at each verified position; ``p_x`` / ``q_x`` ``[S,
    k]`` the modified-target and draft probabilities of each drafted
    token; ``u`` ``[S, k]`` uniforms (a sampled row accepts while
    ``u·q(x) < p(x)``); ``repl`` ``[S, k+1]`` residual / bonus samples;
    ``greedy_row`` ``[S]`` bool, rows that accept by argmax equality;
    ``budget`` ``[S]`` tokens still owed (at least 1 counts); ``eos``
    ``[S]`` EOS id, -1 for none: emission stops with the first EOS.

    Returns ``(emit [S, k+1], n_emit [S], n_acc [S])`` int32: slot ``s``
    emits ``emit[s, :n_emit[s]]``, ``n_emit >= 1``, and its cache length
    advances by exactly ``n_emit[s]``."""
    s, k = drafted.shape
    dev = drafted.device
    acc_samp = u * q_x < p_x
    acc_greedy = drafted == greedy[:, :k]
    acc = torch.where(greedy_row[:, None], acc_greedy, acc_samp)
    n_acc = torch.cumprod(acc.int(), dim=1).sum(dim=1)
    j = torch.arange(k + 1, device=dev)[None, :]
    repl_tok = torch.where(greedy_row[:, None], greedy, repl)
    drafted_pad = torch.nn.functional.pad(drafted, (0, 1))
    emit = torch.where(
        j < n_acc[:, None],
        drafted_pad,
        torch.where(j == n_acc[:, None], repl_tok, torch.zeros_like(repl_tok)),
    ).int()
    n_prelim = n_acc + 1
    is_eos = (eos[:, None] >= 0) & (emit == eos[:, None]) & (j < n_prelim[:, None])
    eos_idx = torch.where(is_eos, j, torch.full_like(j, k + 1)).amin(dim=1)
    n_emit = torch.minimum(n_prelim, torch.minimum(eos_idx + 1, budget.clamp_min(1)))
    return emit, n_emit.int(), n_acc.int()


def verify_reference(
    logits, drafted, qprobs, temperature, top_k, *, k_cap: int = 128,
    block_size: int = 8192, generator=None, noise=None, buffer_noise=None,
):
    """The full-logits verifier. ``logits`` ``[N, V]`` f32 target logits
    (a row per slot × position), ``drafted`` ``[N]`` the token each row
    scored (any value on bonus rows), ``qprobs`` ``[N, V]`` the draft's
    probabilities (zeros on bonus rows: the residual is then a plain
    target sample), ``temperature`` / ``top_k`` ``[N]``. Returns
    ``(greedy [N] int32, p_x [N] f32, repl [N] int32)``.

    Noise contract, shared with
    :func:`~mpit_tpu_torch.ops.lm_head.lm_head_verify` (so the two are
    bitwise comparable at one vocabulary block) and with JAX's
    ``fold_in`` streams, whose draws the tests hand over as tensors:
    block ``b`` of the residual's full-vocabulary draw takes columns
    ``b·block`` onwards of ``noise`` ``[N, n_blocks·block]``
    (``gumbel(fold_in(key, b), (N, block))`` in JAX), the top-k buffer's
    draw ``buffer_noise`` ``[N, min(k_cap, V)]`` (``gumbel(fold_in(key,
    n_blocks), ...)``). Without them, ``generator`` draws the buffer's
    first, then each block's, only when a row samples the full
    vocabulary. Top-k thresholds at the k-th largest logit inside the
    width-``k_cap`` candidate buffer, as ``lm_head_sample`` does."""
    n, vocab = logits.shape
    dev = logits.device
    block = min(block_size, vocab + (-vocab) % 128)
    temperature = temperature.float().to(dev)
    top_k = top_k.to(dev)
    temp = temperature.clamp_min(1e-6)
    greedy = logits.argmax(dim=1).int()
    scaled = logits / temp[:, None]
    m = scaled.amax(dim=1)
    lse_full = m + torch.log(torch.exp(scaled - m[:, None]).sum(dim=1))
    kb = min(k_cap, vocab)
    bv, bi = torch.topk(logits, kb, dim=1)  # descending: the buffer's order
    kk = top_k.long().clamp(1, kb)
    thresh = bv.gather(1, (kk - 1)[:, None])[:, 0]
    keep = bv >= thresh[:, None]
    sc_b = bv / temp[:, None]
    m_b = torch.where(keep, sc_b, float("-inf")).amax(dim=1)
    lse_topk = m_b + torch.log(
        torch.where(keep, torch.exp(sc_b - m_b[:, None]), 0.0).sum(dim=1)
    )
    lx = logits.gather(1, drafted.long()[:, None])[:, 0]
    p_x = torch.where(
        top_k > 0,
        torch.where(lx >= thresh, torch.exp(lx / temp - lse_topk), 0.0),
        torch.exp(lx / temp - lse_full),
    )
    q_b = qprobs.gather(1, bi)
    p_b = torch.where(keep, torch.exp(sc_b - lse_topk[:, None]), 0.0)
    res_b = torch.clamp_min(p_b - q_b, 0.0)
    g_b = gumbel_columns(buffer_noise, 0, kb, n, generator, dev)
    buf_tok = bi.gather(1, (torch.log(res_b) + g_b).argmax(dim=1)[:, None])[:, 0]
    full_tok = torch.zeros((n,), dtype=torch.int64, device=dev)
    if bool(((top_k == 0) & (temperature > 0.0)).any()):
        best = torch.full((n,), float("-inf"), device=dev)
        for off in range(0, vocab, block):
            width = min(block, vocab - off)
            p_blk = torch.exp(scaled[:, off : off + width] - lse_full[:, None])
            res = torch.clamp_min(p_blk - qprobs[:, off : off + width], 0.0)
            score = torch.log(res) + gumbel_columns(noise, off, width, n, generator, dev)
            sm, smi = score.max(dim=1)
            upd = sm > best
            best = torch.where(upd, sm, best)
            full_tok = torch.where(upd, smi + off, full_tok)
    repl = torch.where(top_k > 0, buf_tok, full_tok).int()
    return greedy, p_x, repl

