"""Batched GPT-2 inference engine over a dense per-slot KV cache.

The execution contract, as in :mod:`mpit_tpu.serve.engine`:

- **Prefill** writes each admitted request's padded prompt into its
  slot's cache from position 0 and samples the request's first output
  token from the output at ``prompt_len - 1``.
- **Decode** appends one token per active slot at its current length
  and samples the next.
- **Sampling** takes per-slot temperature / top-k arrays, so requests
  with different settings batch together.

``decode_attention="kernel"`` runs attention through the flash-decode
kernel (:func:`mpit_tpu_torch.ops.flash_decode_attention`) and samples
through the blocked LM head (:func:`mpit_tpu_torch.ops.lm_head_sample`,
no ``[slots, vocab]`` logits); ``"reference"`` runs the plain
:func:`~mpit_tpu_torch.models.gpt2.cached_attention` and samples from
materialized logits (:func:`sample_tokens`), the parity oracle.

The cache is updated in place (JAX rebuilds it each step): prefill runs
the forward on the admitted slots only, over a copy of their buffers
that is written back; decode runs all slots and writes every slot's row
at its length, free slots (length clamped to 0) included — their row 0
is junk that the next admission's prefill overwrites.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpit_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mpit_tpu_torch.ops.decode_attention import (
    flash_decode_attention,
    kernel_library,
    pick_block_k,
)
from mpit_tpu_torch.ops.lm_head import gumbel, lm_head_sample
from mpit_tpu_torch.serve.kvcache import KVCache, alloc_cache

__all__ = ["Engine", "modified_logits", "resolve_device", "sample_tokens"]

# "kernel" = flash-decode kernel + blocked head; "reference" = plain
# cached attention + dense sampling. The JAX package's "interpret"
# (the Pallas interpreter) has no counterpart here.
_DECODE_MODES = ("kernel", "reference")
_DTYPE_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable
    GPU raises: the port never carries on, on the CPU, unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def modified_logits(logits, temperature, top_k):
    """Per-slot top-k threshold (at the k-th largest logit, when
    ``top_k > 0``) then division by ``max(temperature, 1e-6)``."""
    vocab = logits.shape[-1]
    sorted_desc = logits.sort(dim=-1, descending=True).values
    k_idx = (top_k.long() - 1).clamp(0, vocab - 1)
    thresh = sorted_desc.gather(1, k_idx[:, None])
    masked = logits.masked_fill(
        (top_k[:, None] > 0) & (logits < thresh), float("-inf")
    )
    return masked / temperature.float().clamp_min(1e-6)[:, None]


def sample_tokens(logits, temperature, top_k, *, generator=None, noise=None):
    """Per-slot sampling over ``logits`` ``[S, V]`` f32:
    ``temperature <= 0`` is greedy (argmax), else a categorical draw from
    :func:`modified_logits` by the Gumbel-max trick. ``noise`` ``[S, V]``
    replaces the Gumbel draw from ``generator`` (tests feed both
    packages the same numbers). Returns ``[S]`` int32."""
    if noise is None:
        noise = gumbel(logits.shape, generator=generator, device=logits.device)
    scaled = modified_logits(logits, temperature, top_k) + noise.to(logits)
    greedy = temperature <= 0.0
    return torch.where(greedy, logits.argmax(-1), scaled.argmax(-1)).int()


class Engine:
    """Slot-batched KV-cache inference over one GPT-2 ``state_dict``
    (:func:`mpit_tpu_torch.serve.weights.params_from_jax` or
    :func:`~mpit_tpu_torch.serve.weights.load_gpt2_params`).

    Device state lives on the engine (cache + per-slot last token);
    ``active`` and the sampling arrays are passed per call by the
    scheduler. ``device`` defaults to ``"cuda"`` and raises without a
    GPU; the kernel is built at construction, so its compile is set-up
    time and not the first prefill's."""

    def __init__(
        self,
        cfg: GPT2Config,
        params,
        *,
        slots: int = 8,
        max_len: int | None = None,
        prefill_len: int | None = None,
        seed: int = 0,
        device="cuda",
        decode_attention: str = "kernel",
        sample_k_cap: int = 128,
    ):
        if decode_attention not in _DECODE_MODES:
            raise ValueError(
                f"decode_attention must be one of {_DECODE_MODES}, got "
                f"{decode_attention!r}"
            )
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = min(max_len or cfg.max_seq_len, cfg.max_seq_len)
        self.prefill_len = min(prefill_len or self.max_len, self.max_len)
        # The kernel's cache-length tile (its default for this max_len).
        self.decode_block_k = pick_block_k(self.max_len)
        self.decode_attention = decode_attention
        self._blocked_head = decode_attention == "kernel"
        if self._blocked_head:
            cfg = dataclasses.replace(
                cfg, cache_attention_fn=flash_decode_attention
            )
            if self.device.type == "cuda":
                kernel_library()
        self.cfg = cfg  # what the forward really runs, kernel included
        self.decode_sampler = "blocked" if self._blocked_head else "dense"
        # The blocked sampler bounds top_k by its candidate buffer; the
        # scheduler validates at submit. None = dense path, no bound.
        self.sample_k_cap = sample_k_cap if self._blocked_head else None
        self.kv_dtype = _DTYPE_SHORT.get(cfg.dtype, str(cfg.dtype))
        self.weights_dtype = "f32"
        self.model = GPT2(cfg, device=self.device)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        self.cache: KVCache = alloc_cache(
            cfg, slots, self.max_len, device=self.device
        )
        self.last_token = torch.zeros(
            (slots,), dtype=torch.int32, device=self.device
        )
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sample_last(self, out, gather_idx, temp, topk):
        """Token per row from the forward's output at ``gather_idx``:
        the hidden row streamed through the blocked head, or the logits
        row sampled densely."""
        row = out[torch.arange(out.shape[0], device=self.device), gather_idx]
        if not self._blocked_head:
            return sample_tokens(row.float(), temp, topk, generator=self._gen)
        return lm_head_sample(
            row,
            self.model.head_weight(),
            temp,
            topk,
            generator=self._gen,
            k_cap=self.sample_k_cap,
            compute_dtype=self.cfg.head_dtype,
        )

    @torch.no_grad()
    def prefill(self, tokens, prompt_lens, admit, temp, topk) -> np.ndarray:
        """Admit requests: ``tokens`` ``[slots, prefill_len]`` (padded),
        ``prompt_lens``/``admit``/``temp``/``topk`` ``[slots]``. Returns
        the per-slot last token (the first OUTPUT token for admitted
        slots) as host numpy; the fetch is the step's completion fence."""
        admit = np.asarray(admit, bool)
        if admit.any():
            idx = self._tensor(np.flatnonzero(admit), torch.long)
            toks = self._tensor(np.asarray(tokens)[admit], torch.long)
            plen = self._tensor(np.asarray(prompt_lens)[admit], torch.int32)
            c = self.cache
            k, v = c.k[:, idx], c.v[:, idx]  # copies, written back below
            fresh = torch.zeros_like(plen)
            out, _ = self.model(
                toks, cache=(k, v, fresh), return_hidden=self._blocked_head
            )
            tok = self._sample_last(
                out,
                (plen.long() - 1).clamp_min(0),
                self._tensor(np.asarray(temp)[admit], torch.float32),
                self._tensor(np.asarray(topk)[admit], torch.int32),
            )
            c.k[:, idx] = k
            c.v[:, idx] = v
            c.lengths[idx] = plen
            self.last_token[idx] = tok
        return self.last_token.cpu().numpy()

    @torch.no_grad()
    def decode(self, active, temp, topk) -> np.ndarray:
        """One decode tick over the slot batch; returns the per-slot
        next token (host numpy; stale for inactive slots)."""
        active = self._tensor(active, torch.bool)
        c = self.cache
        # Inactive slots are free slots: their length is clamped to 0,
        # so the kernel visits one tile for them, not a retired
        # request's whole context.
        lens = torch.where(active, c.lengths, 0)
        out, _ = self.model(
            self.last_token[:, None].long(),
            cache=(c.k, c.v, lens),
            return_hidden=self._blocked_head,
        )
        tok = self._sample_last(
            out,
            torch.zeros(self.slots, dtype=torch.long, device=self.device),
            self._tensor(temp, torch.float32),
            self._tensor(topk, torch.int32),
        )
        c.lengths = torch.where(active, lens + 1, lens)
        self.last_token = torch.where(active, tok, self.last_token)
        return self.last_token.cpu().numpy()

    def lengths(self) -> np.ndarray:
        return self.cache.lengths.cpu().numpy()

    def reset(self, seed: int = 0) -> None:
        """Clear all slots and re-seed the sampler."""
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.cache.lengths.zero_()
        self.last_token.zero_()
        self._gen.manual_seed(seed)
