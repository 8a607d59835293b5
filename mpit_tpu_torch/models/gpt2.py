"""GPT-2 in PyTorch: the serving model of the port.

Pre-LN GPT-2: learned positional embeddings, causal self-attention,
tanh-approximated GELU MLP, weight-tied LM head. Layout and numerics
follow :mod:`mpit_tpu.models.gpt2` so that the two packages agree on the
same weights:

- dense kernels are stored ``[in, out]`` (the flax layout) and applied
  as ``x @ kernel + bias`` after casting x, kernel and bias to
  ``cfg.dtype``;
- LayerNorm statistics are f32, epsilon ``1e-6``, output in
  ``cfg.ln_out_dtype``;
- attention tensors are ``[B, T, H, Dh]``; scores and softmax are f32
  and the probabilities are cast back to the query dtype before the PV
  product;
- the LM head multiplies operands rounded to ``cfg.head_dtype`` in f32.

Parameter names mirror the flax tree (``wte``, ``wpe``,
``blocks.<i>.qkv.kernel`` for ``block_<i>/qkv/kernel``, ``ln_f.scale``,
...), so :func:`mpit_tpu_torch.serve.weights.params_from_jax` is a
renaming, with no transposes.

The cache path (``cache=(k, v, lengths)``) writes the new K/V rows into
the caller's buffers IN PLACE and returns the same tensors: unlike
JAX, PyTorch need not rebuild a cache to update it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "GPT2",
    "GPT2Config",
    "cache_update",
    "cached_attention",
    "default_attention",
]


def default_attention(q, k, v):
    """Plain causal attention, ``[B, T, H, Dh]`` throughout: softmax of
    f32 scores, probabilities cast to q's dtype before the PV product."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    t_q, t_k = scores.shape[-2], scores.shape[-1]
    mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril(
        t_k - t_q
    )
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def cache_update(cache, new, lengths):
    """Write ``new`` ``[B, T, H, Dh]`` into ``cache`` ``[B, S, H, Dh]`` at
    rows ``lengths .. lengths + T - 1`` of each slot, in place; returns
    ``cache``. A start that would overrun S is clamped to ``S - T``, as
    ``lax.dynamic_update_slice`` clamps it in the JAX package."""
    b, t = new.shape[:2]
    start = lengths.long().clamp(0, cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=cache.device)
    slot = torch.arange(b, device=cache.device)[:, None]
    cache[slot, rows] = new.to(cache.dtype)
    return cache


def cached_attention(q, k, v, lengths):
    """Causal attention of new queries against a padded KV cache.

    ``q`` ``[B, T, H, Dh]`` are the T newest positions (global position
    ``lengths + t``); ``k``/``v`` ``[B, S, H, Dh]`` are the whole cache
    buffers with the new rows already written. Key ``j`` is visible to
    query ``t`` iff ``j <= lengths + t``; masked keys score ``-inf`` and
    contribute exact zeros. The serving reference, and the plain version
    of the flash-decode kernel."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    t_q, s_max = q.shape[1], k.shape[1]
    q_pos = lengths.long()[:, None] + torch.arange(t_q, device=q.device)
    key = torch.arange(s_max, device=q.device)
    valid = key[None, None, :] <= q_pos[:, :, None]  # [B, T, S]
    scores = scores.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int | None = None  # default 4 * d_model
    dtype: torch.dtype = torch.bfloat16  # activations and matmul operands
    ln_dtype: torch.dtype | None = None  # LayerNorm output; None = dtype
    head_dtype: torch.dtype = torch.float32  # LM-head operand dtype
    tie_head: bool = True
    # Attention on the cache path, ``(q, k_cache, v_cache, lengths)``.
    # None = :func:`cached_attention`; the serving engine plugs in the
    # flash-decode kernel wrapper here.
    cache_attention_fn: Any = None

    @property
    def ln_out_dtype(self) -> torch.dtype:
        return self.dtype if self.ln_dtype is None else self.ln_dtype

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @staticmethod
    def small(**kw) -> "GPT2Config":
        """GPT-2 small (124M)."""
        return GPT2Config(**kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """Test-sized config."""
        defaults = dict(
            vocab_size=512, max_seq_len=128, num_layers=2, num_heads=4, d_model=64
        )
        defaults.update(kw)
        return GPT2Config(**defaults)


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with the kernel stored ``[in, out]``;
    x, kernel and bias are cast to ``dtype`` first."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def reset_parameters(self, generator) -> None:
        _lecun_normal_(self.kernel.data, generator)
        self.bias.data.zero_()

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, epsilon 1e-6, params
    ``scale``/``bias``, output in ``dtype``."""

    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, 1e-6)
        return y.to(self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.ln1 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.qkv = Dense(d, 3 * d, dt, device)
        self.proj = Dense(d, d, dt, device)
        self.ln2 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.fc = Dense(d, cfg.ff_dim, dt, device)
        self.out = Dense(cfg.ff_dim, d, dt, device)

    def forward(self, x, layer_cache=None):
        """``layer_cache``: ``(k, v, lengths)`` with k/v ``[B, S, H, Dh]``
        and lengths ``[B]`` — the new K/V rows are written into k/v at
        ``lengths`` (in place) and attention runs against the cache."""
        cfg = self.cfg
        h = self.ln1(x)
        q, k, v = self.qkv(h).split(cfg.d_model, dim=-1)
        split = lambda t: t.reshape(*t.shape[:-1], cfg.num_heads, cfg.head_dim)
        if layer_cache is None:
            attn = default_attention(split(q), split(k), split(v))
        else:
            k_cache, v_cache, lengths = layer_cache
            cache_update(k_cache, split(k), lengths)
            cache_update(v_cache, split(v), lengths)
            attn_fn = cfg.cache_attention_fn or cached_attention
            attn = attn_fn(split(q).contiguous(), k_cache, v_cache, lengths)
        attn = attn.reshape(*attn.shape[:-2], cfg.d_model)
        x = x + self.proj(attn)
        h = F.gelu(self.fc(self.ln2(x)), approximate="tanh")
        return x + self.out(h)


class GPT2(nn.Module):
    """GPT-2 with the flax parameter tree's names and layouts.

    ``generator`` (a CPU ``torch.Generator``) draws the flax
    initialisation — ``wte ~ N(0, 0.02)``, ``wpe ~ N(0, 0.01)``,
    lecun-normal kernels, zero biases, unit LayerNorm scales — on the
    CPU and then moves it to ``device``; without one the parameters are
    left for :meth:`load_state_dict`."""

    def __init__(self, cfg: GPT2Config, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        v, d = cfg.vocab_size, cfg.d_model
        init_dev = "cpu" if generator is not None else device
        self.wte = nn.Parameter(torch.empty(v, d, device=init_dev))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d, device=init_dev))
        self.blocks = nn.ModuleList(
            Block(cfg, init_dev) for _ in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(d, cfg.ln_out_dtype, init_dev)
        self.head = (
            None
            if cfg.tie_head
            else nn.Parameter(torch.empty(v, d, device=init_dev))
        )
        if generator is not None:
            self.reset_parameters(generator)
            self.to(device)

    def reset_parameters(self, generator) -> None:
        nn.init.normal_(self.wte.data, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe.data, 0.0, 0.01, generator=generator)
        for mod in self.modules():
            if isinstance(mod, (Dense, LayerNorm)):
                mod.reset_parameters(generator)
        if self.head is not None:
            nn.init.normal_(self.head.data, 0.0, 0.02, generator=generator)

    def head_weight(self) -> torch.Tensor:
        """The LM-head weight ``[vocab, d_model]``: ``wte`` when tied."""
        return self.wte if self.head is None else self.head

    def forward(self, tokens, cache=None, return_hidden=False):
        """``tokens`` ``[B, T]`` → logits ``[B, T, vocab]`` f32.

        ``cache``: ``(k, v, lengths)`` with k/v ``[num_layers, B, S, H,
        Dh]`` and lengths ``[B]`` int32, the tokens already cached per
        slot. The T new tokens are written at ``lengths`` (in place) and
        attend causally against the cache from positions ``lengths +
        arange(T)``; the return becomes ``(out, (k, v))``.
        ``return_hidden`` (requires ``cache``) skips the head and
        returns the final post-``ln_f`` hiddens ``[B, T, d_model]``.
        """
        cfg = self.cfg
        if return_hidden and cache is None:
            raise ValueError("return_hidden is the serving path; it requires cache=")
        t = tokens.shape[-1]
        if cache is None:
            pe = self.wpe[:t]
        else:
            cache_k, cache_v, cache_lengths = cache
            positions = cache_lengths.long()[:, None] + torch.arange(
                t, device=tokens.device
            )
            pe = self.wpe[positions]
        x = self.wte[tokens].to(cfg.dtype) + pe.to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            if cache is None:
                x = block(x)
            else:
                x = block(x, (cache_k[i], cache_v[i], cache_lengths))
        x = self.ln_f(x)
        if return_hidden:
            return x, (cache_k, cache_v)
        hd = cfg.head_dtype
        head = self.head_weight()
        logits = x.to(hd).float() @ head.to(hd).float().T
        if cache is not None:
            return logits, (cache_k, cache_v)
        return logits
