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
JAX, PyTorch need not rebuild a cache to update it. The paged path
(``paged_cache=(k_pools, v_pools, lengths, block_tables,
write_valid)``) writes through each slot's block table into a shared
page pool, in place too. A :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`
cache or pool quantizes on write and dequantizes in the plain attention.

A model built with ``quantized=True`` holds the int8 weight store: the
``qkv``/``proj``/``fc``/``out`` kernels, ``wte`` and an untied ``head``
sit in :class:`QuantizedWeight` seats (state keys ``<leaf>.q`` int8 and
``<leaf>.scale`` f32, e.g. ``blocks.0.qkv.kernel.q``). Dense layers run
``cfg.quant_matmul_fn`` on them and add the bias in f32; the embedding
dequantizes only the rows it gathers; the LM head runs
:func:`~mpit_tpu_torch.ops.quantized_matmul.quantized_matmul_t`.

The training path (no cache) runs ``cfg.attention_fn`` — the flash
kernel's wrapper plugs in there — optionally recomputes each block in
the backward (``cfg.remat``, :func:`torch.utils.checkpoint.checkpoint`),
and with ``targets`` returns per-token losses through the blocked
:func:`~mpit_tpu_torch.ops.lm_head.lm_head_xent` instead of logits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mpit_tpu_torch.models.layers import lecun_normal_
from mpit_tpu_torch.ops.kv_quant import QuantizedKV, dequantize_kv, quantize_kv
from mpit_tpu_torch.ops.lm_head import lm_head_xent
from mpit_tpu_torch.ops.quantized_matmul import (
    QuantizedTensor,
    dequantize_tensor,
    quantized_matmul,
    quantized_matmul_t,
)

__all__ = [
    "GPT2",
    "GPT2Config",
    "QuantizedWeight",
    "cache_update",
    "cached_attention",
    "default_attention",
    "paged_cache_update",
    "paged_cached_attention",
    "paged_gather",
    "paged_write_index",
]


def default_attention(q, k, v, *, causal: bool = True):
    """Plain attention, ``[B, T, H, Dh]`` throughout: softmax of f32
    scores, probabilities cast to q's dtype before the PV product. With
    ``causal``, key ``j`` is visible to query ``i`` iff ``j <= i + Tk -
    Tq``."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril(
            t_k - t_q
        )
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def cache_update(cache, new, lengths, valid=None):
    """Write ``new`` ``[B, T, H, Dh]`` into ``cache`` ``[B, S, H, Dh]`` at
    rows ``lengths .. lengths + T - 1`` of each slot, in place; returns
    ``cache``. A start that would overrun S is clamped to ``S - T``, as
    ``lax.dynamic_update_slice`` clamps it in the JAX package. Rows with
    ``valid`` ``[B, T]`` False keep what they held (JAX's ``_kv_where``
    of the speculative verify: a slot that takes no part keeps its
    rows)."""
    b, t = new.shape[:2]
    start = lengths.long().clamp(0, cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=new.device)
    slot = torch.arange(b, device=new.device)[:, None]
    if isinstance(cache, QuantizedKV):
        new = quantize_kv(new)
        if valid is not None:
            old, keep = cache[slot, rows], ~valid[:, :, None, None]
            new = QuantizedKV(q=torch.where(keep, old.q, new.q),
                              scale=torch.where(keep, old.scale, new.scale))
        cache[slot, rows] = new
    else:
        new = new.to(cache.dtype)
        if valid is not None:
            new = torch.where(valid[:, :, None, None], new, cache[slot, rows])
        cache[slot, rows] = new
    return cache


def paged_write_index(pool, lengths, block_table, t: int, valid=None):
    """Flat rows ``[B * T]`` of ``pool`` ``[P + 1, page_size, H, Dh]``
    where positions ``lengths .. lengths + T - 1`` of each slot are
    written: ``bt[b, pos // ps] * ps + pos % ps``.

    Dropped writes go to a trash page. A pool holds one page more than
    the allocator hands out, its last (index P); no block table names
    it and nothing reads it. Rows that must not land — ``valid`` ``[B,
    T]`` False (prefill padding, positions below a shared-prefix floor,
    inactive slots) and positions past the slot's virtual capacity — are
    written there. JAX drops them in its scatter (``mode="drop"``);
    PyTorch raises on an out-of-range index instead, and page 0, where a
    zeroed table entry points, may belong to another slot. The index is
    built once per forward and serves every layer, with no host sync."""
    ps, trash = pool.shape[1], pool.shape[0] - 1
    pos = lengths.long()[:, None] + torch.arange(t, device=lengths.device)
    n_ps = block_table.shape[1]
    page = block_table.gather(1, (pos // ps).clamp(0, n_ps - 1)).long()
    drop = pos >= n_ps * ps
    if valid is not None:
        drop = drop | ~valid
    return (torch.where(drop, trash, page) * ps + pos % ps).reshape(-1)


def paged_scatter(pool, new, idx):
    """Write ``new`` ``[B, T, H, Dh]`` into the flat pool rows ``idx``
    (:func:`paged_write_index`), in place, quantizing first when the
    pool is a :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`."""
    rows = new.reshape(-1, *new.shape[2:])
    if isinstance(pool, QuantizedKV):
        qn = quantize_kv(rows)
        pool.q.view(-1, *pool.q.shape[2:])[idx] = qn.q
        pool.scale.view(-1, *pool.scale.shape[2:])[idx] = qn.scale
    else:
        pool.view(-1, *pool.shape[2:])[idx] = rows.to(pool.dtype)
    return pool


def paged_cache_update(pool, new, lengths, block_table, valid=None):
    """Write ``new`` ``[B, T, H, Dh]`` into ``pool`` ``[P + 1, page_size,
    H, Dh]`` at positions ``lengths .. lengths + T - 1`` through
    ``block_table`` ``[B, pages_per_slot]``, in place; returns ``pool``.
    Masked rows and rows past the virtual capacity go to the trash page
    (:func:`paged_write_index`)."""
    idx = paged_write_index(pool, lengths, block_table, new.shape[1], valid)
    return paged_scatter(pool, new, idx)


def paged_gather(pool, block_table):
    """Each slot's dense view of the pool: ``[P + 1, ps, H, Dh]``
    through ``[B, pages_per_slot]`` → ``[B, pages_per_slot · ps, H,
    Dh]`` (q and scale together for a quantized pool). Rows past a
    slot's fill are whatever the named pages hold; the attention mask
    defines validity."""
    if isinstance(pool, QuantizedKV):
        return QuantizedKV(
            q=paged_gather(pool.q, block_table),
            scale=paged_gather(pool.scale, block_table),
        )
    g = pool[block_table.long()]
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def paged_cached_attention(q, k_pool, v_pool, lengths, block_table):
    """Plain paged attention: gather the dense per-slot view, then
    :func:`cached_attention`. The paged kernel's plain version."""
    return cached_attention(
        q,
        paged_gather(k_pool, block_table),
        paged_gather(v_pool, block_table),
        lengths,
    )


def cached_attention(q, k, v, lengths):
    """Causal attention of new queries against a padded KV cache.

    ``q`` ``[B, T, H, Dh]`` are the T newest positions (global position
    ``lengths + t``); ``k``/``v`` ``[B, S, H, Dh]`` are the whole cache
    buffers with the new rows already written. Key ``j`` is visible to
    query ``t`` iff ``j <= lengths + t``; masked keys score ``-inf`` and
    contribute exact zeros. The serving reference, and the plain version
    of the flash-decode kernel.

    Quantized buffers are dequantized to f32 whole. Operands of unequal
    dtypes (a bf16 model over an f32 or int8 cache) are promoted before
    each product, as ``jnp.einsum`` promotes them; the probabilities are
    cast to q's dtype first, so the output has the promoted dtype."""
    if isinstance(k, QuantizedKV):
        k, v = dequantize_kv(k), dequantize_kv(v)
    dh = q.shape[-1]
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)).float()
    scores = scores / math.sqrt(dh)
    t_q, s_max = q.shape[1], k.shape[1]
    q_pos = lengths.long()[:, None] + torch.arange(t_q, device=q.device)
    key = torch.arange(s_max, device=q.device)
    valid = key[None, None, :] <= q_pos[:, :, None]  # [B, T, S]
    scores = scores.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))


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
    # Attention on the training path, ``(q, k, v, *, causal=True)`` over
    # ``[B, T, H, Dh]``; the flash kernel's wrapper plugs in here.
    attention_fn: Any = default_attention
    # Recompute each block in the backward instead of keeping its
    # activations (torch.utils.checkpoint, non-reentrant).
    remat: bool = False
    # Attention on the cache path, ``(q, k_cache, v_cache, lengths)``.
    # None = :func:`cached_attention`; the serving engine plugs in the
    # flash-decode kernel wrapper here.
    cache_attention_fn: Any = None
    # Attention on the paged path, ``(q, k_pool, v_pool, lengths,
    # block_table)``. None = :func:`paged_cached_attention`; the paged
    # engine plugs in the paged flash-decode kernel wrapper.
    paged_attention_fn: Any = None
    # Matmul of a dense layer whose kernel is quantized, ``(x,
    # QuantizedTensor) -> f32 [..., F]``. None = :func:`quantized_matmul`
    # (the CUDA kernel on the card, its plain version on the CPU); the
    # serving engine plugs in its choice. Never called for plain kernels.
    quant_matmul_fn: Any = None
    # Row-block of the quantized matmuls' plain versions; 0 = their
    # default (256). Tests shrink it so tiny configs tile several blocks.
    quant_block_rows: int = 0

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


class QuantizedWeight(nn.Module):
    """The seat of one int8-stored weight: buffers ``q`` int8 ``q_shape``
    (``[rows, cols]``) and ``scale`` f32 ``scale_shape`` (``[rows, 1]``),
    which ``state_dict`` carries as ``<seat>.q`` and ``<seat>.scale``.
    Nothing dequantizes them at load."""

    def __init__(self, q_shape, scale_shape, device=None):
        super().__init__()
        self.register_buffer("q", torch.zeros(q_shape, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(scale_shape, device=device))

    def tensor(self) -> QuantizedTensor:
        return QuantizedTensor(q=self.q, scale=self.scale)


def _seat(rows: int, cols: int, quantized: bool, device):
    """A weight seat: an int8 :class:`QuantizedWeight`, or a parameter."""
    if quantized:
        return QuantizedWeight((rows, cols), (rows, 1), device)
    return nn.Parameter(torch.empty(rows, cols, device=device))


def _weight(seat):
    """What a seat holds: a :class:`QuantizedTensor` or the tensor."""
    return seat.tensor() if isinstance(seat, QuantizedWeight) else seat


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with the kernel stored ``[in, out]``;
    x, kernel and bias are cast to ``dtype`` first. Given
    ``quant_matmul_fn``, the kernel is an int8 seat instead: ``y =
    quant_matmul_fn(x, kernel)``, the bias added in f32, then cast to
    ``dtype``."""

    def __init__(
        self, d_in: int, d_out: int, dtype, device=None, *, quant_matmul_fn=None
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = _seat(d_in, d_out, quant_matmul_fn is not None, device)
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.matmul_fn = quant_matmul_fn

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.kernel.data, generator)
        self.bias.data.zero_()

    def forward(self, x):
        dt = self.dtype
        if isinstance(self.kernel, QuantizedWeight):
            y = self.matmul_fn(x, self.kernel.tensor())
            return (y + self.bias).to(dt)
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
    def __init__(self, cfg: GPT2Config, device=None, quantized=False):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        qmm = None
        if quantized:
            qmm = cfg.quant_matmul_fn or functools.partial(
                quantized_matmul, block_rows=cfg.quant_block_rows or None
            )
        dense = functools.partial(Dense, dtype=dt, device=device, quant_matmul_fn=qmm)
        self.ln1 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.qkv = dense(d, 3 * d)
        self.proj = dense(d, d)
        self.ln2 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.fc = dense(d, cfg.ff_dim)
        self.out = dense(cfg.ff_dim, d)

    def forward(self, x, layer_cache=None):
        """``layer_cache``: ``(k, v, lengths, write_valid)`` with k/v
        ``[B, S, H, Dh]``, lengths ``[B]`` and ``write_valid`` ``[B, T]``
        or None — the new K/V rows are written into k/v at ``lengths``
        (in place, the rows ``write_valid`` marks False kept) and
        attention runs against the cache. The
        paged 5-tuple ``(k_pool, v_pool, lengths, block_table,
        write_idx)`` writes the rows at ``write_idx``, the flat pool rows
        :func:`GPT2.forward` built once for all layers (masked rows go
        to the trash page), and runs ``cfg.paged_attention_fn``."""
        cfg = self.cfg
        h = self.ln1(x)
        q, k, v = self.qkv(h).split(cfg.d_model, dim=-1)
        split = lambda t: t.reshape(*t.shape[:-1], cfg.num_heads, cfg.head_dim)
        if layer_cache is None:
            attn = cfg.attention_fn(split(q), split(k), split(v), causal=True)
        elif len(layer_cache) == 5:
            k_pool, v_pool, lengths, block_table, write_idx = layer_cache
            paged_scatter(k_pool, split(k), write_idx)
            paged_scatter(v_pool, split(v), write_idx)
            attn_fn = cfg.paged_attention_fn or paged_cached_attention
            attn = attn_fn(
                split(q).contiguous(), k_pool, v_pool, lengths, block_table
            )
        else:
            k_cache, v_cache, lengths, valid = layer_cache
            cache_update(k_cache, split(k), lengths, valid)
            cache_update(v_cache, split(v), lengths, valid)
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
    left for :meth:`load_state_dict`. ``quantized=True`` seats the int8
    weight store (a ``quantize_gpt2_params`` state), which is loaded,
    never initialised. ``make_block(cfg, device, quantized)`` builds each
    block (default :class:`Block`; the tensor-parallel engine's
    :class:`~mpit_tpu_torch.serve.tp.TPGPT2` passes its own)."""

    def __init__(
        self, cfg: GPT2Config, *, device=None, generator=None, quantized=False,
        make_block=None,
    ):
        super().__init__()
        if quantized and generator is not None:
            raise ValueError(
                "a quantized model is loaded (load_state_dict of a "
                "quantize_gpt2_params state), not initialised"
            )
        self.cfg = cfg
        v, d = cfg.vocab_size, cfg.d_model
        init_dev = "cpu" if generator is not None else device
        self.wte = _seat(v, d, quantized, init_dev)
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d, device=init_dev))
        self.blocks = nn.ModuleList(
            (make_block or Block)(cfg, init_dev, quantized) for _ in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(d, cfg.ln_out_dtype, init_dev)
        self.head = None if cfg.tie_head else _seat(v, d, quantized, init_dev)
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

    def cache_layer(self, buf, i: int):
        """Layer ``i``'s view of a cache or pool buffer ``[num_layers,
        ...]``: ``buf[i]``."""
        return buf[i]

    def write_pool(self, buf):
        """The ``[P + 1, page_size, H, Dh]`` pool whose geometry the
        paged write index is built on: layer 0's."""
        return buf[0]

    def head_weight(self):
        """The LM-head weight ``[vocab, d_model]``: ``wte`` when tied; a
        :class:`QuantizedTensor` in a quantized model."""
        return _weight(self.wte if self.head is None else self.head)

    def embed(self, tokens):
        """The token embeddings ``[B, T, d_model]`` (f32, or the
        dequantized rows of an int8 table)."""
        emb = _weight(self.wte)[tokens]
        if isinstance(emb, QuantizedTensor):
            # The gathered int8 rows and their scales: activation-sized,
            # never the [vocab, d_model] table.
            emb = dequantize_tensor(emb)
        return emb

    def head_xent(self, x, targets):
        """Per-token losses ``[B, T]`` of the head over the final hiddens
        ``x``: the fused blocked cross entropy."""
        return lm_head_xent(x, self.head_weight(), targets, compute_dtype=self.cfg.head_dtype)

    def forward(
        self, tokens, cache=None, paged_cache=None, return_hidden=False,
        targets=None, positions=None,
    ):
        """``tokens`` ``[B, T]`` → logits ``[B, T, vocab]`` f32.

        ``positions`` (``[T]`` or ``[B, T]``; JAX's ``positions``, no
        cache) replaces the default ``0 .. T - 1``: under context
        parallelism each shard's tokens sit at ``s·T_local + arange``.

        ``targets`` ``[B, T]`` (training; no cache) switches the head to
        the fused blocked cross entropy and returns per-token losses
        ``[B, T]`` f32 — the ``[B, T, vocab]`` logits never exist. Its
        products take operands in ``cfg.head_dtype`` with f32 results.

        ``cache``: ``(k, v, lengths)`` with k/v ``[num_layers, B, S, H,
        Dh]`` and lengths ``[B]`` int32, the tokens already cached per
        slot. The T new tokens are written at ``lengths`` (in place) and
        attend causally against the cache from positions ``lengths +
        arange(T)``; the return becomes ``(out, (k, v))``. A fourth
        element ``write_valid`` ``[B, T]`` bool keeps the rows it marks
        False as they were.

        ``paged_cache``: ``(k_pools, v_pools, lengths, block_tables,
        write_valid)`` with pools ``[num_layers, P + 1, page_size, H,
        Dh]`` (the last page is the trash page), ``block_tables`` ``[B,
        pages_per_slot]`` int32 and ``write_valid`` ``[B, T]`` bool: the
        rows are written through the block tables (rows with
        ``write_valid`` False are not), attention runs
        ``cfg.paged_attention_fn``, and the return becomes ``(out,
        (k_pools, v_pools))``. Positions are clipped to ``max_seq_len -
        1``: padding rows of a chunk may run past the table, and their
        embeddings are never kept.

        ``return_hidden`` (requires a cache) skips the head and returns
        the final post-``ln_f`` hiddens ``[B, T, d_model]``: the forward
        without the head (JAX's ``with_head=False``), which the blocked
        samplers and a speculative draft's head-less append run.
        """
        cfg = self.cfg
        if cache is not None and paged_cache is not None:
            raise ValueError("cache and paged_cache are mutually exclusive")
        if return_hidden and cache is None and paged_cache is None:
            raise ValueError(
                "return_hidden is the serving path; it requires cache= or "
                "paged_cache="
            )
        if targets is not None and (cache is not None or paged_cache is not None):
            raise ValueError(
                "cache and targets are mutually exclusive: the fused xent "
                "head never materializes the logits decode needs"
            )
        t = tokens.shape[-1]
        if cache is not None:
            cache_k, cache_v, cache_lengths, *cache_valid = cache
            cache_valid = cache_valid[0] if cache_valid else None
        elif paged_cache is not None:
            cache_k, cache_v, cache_lengths, block_tables, write_valid = paged_cache
            write_idx = paged_write_index(
                self.write_pool(cache_k), cache_lengths, block_tables, t, write_valid
            )
        if positions is not None and (cache is not None or paged_cache is not None):
            raise ValueError("positions= is the training path's; a cache places its own rows")
        if cache is None and paged_cache is None:
            pe = self.wpe[:t] if positions is None else self.wpe[positions]
        else:
            positions = cache_lengths.long()[:, None] + torch.arange(
                t, device=tokens.device
            )
            if paged_cache is not None:
                positions = positions.clamp(max=cfg.max_seq_len - 1)
            pe = self.wpe[positions]
        x = self.embed(tokens).to(cfg.dtype) + pe.to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            if cache is not None:
                x = block(x, (self.cache_layer(cache_k, i), self.cache_layer(cache_v, i),
                              cache_lengths, cache_valid))
            elif paged_cache is not None:
                x = block(
                    x,
                    (self.cache_layer(cache_k, i), self.cache_layer(cache_v, i),
                     cache_lengths, block_tables, write_idx),
                )
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        if return_hidden:
            return x, (cache_k, cache_v)
        if targets is not None:
            return self.head_xent(x, targets)
        hd = cfg.head_dtype
        head = self.head_weight()
        if isinstance(head, QuantizedTensor):
            logits = quantized_matmul_t(
                x.to(hd), head, block_rows=cfg.quant_block_rows or None
            )
        else:
            logits = x.to(hd).float() @ head.to(hd).float().T
        if cache is not None or paged_cache is not None:
            return logits, (cache_k, cache_v)
        return logits

    @staticmethod
    def loss_fn(logits, tokens):
        """Next-token cross entropy: logits ``[B, T, V]`` vs tokens ``[B,
        T + 1]``."""
        targets = tokens[:, 1:]
        logits = logits[:, : targets.shape[1]]
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[..., None].long())[..., 0].mean()

    @staticmethod
    def fused_loss_fn(model: "GPT2", tokens):
        """Mean next-token cross entropy through the fused head: tokens
        ``[B, T + 1]``. (JAX's takes the params as an argument; here they
        live in ``model``.)"""
        return model(tokens[:, :-1], targets=tokens[:, 1:]).mean()
