"""The tensor-parallel GPT-2 of the serving engine: the port of
``_tp_forward_body`` with its two cache forms, ``_tp_cache_forward`` and
``_tp_paged_forward`` (:mod:`mpit_tpu.serve.engine`).

:class:`TPGPT2` is :class:`~mpit_tpu_torch.models.gpt2.GPT2` with each
block cut over ``p`` ranks by the Megatron rules
(:mod:`mpit_tpu_torch.parallel.megatron`): ``qkv`` and ``fc``
column-parallel, ``proj`` and ``out`` row-parallel, one rank-order sum
closing each half. Embeddings, LayerNorms, the residual stream, the
final LayerNorm and the head are replicated and run once. The cache or
pool is head-sharded (``alloc_cache(..., ranks=p)``: ``[p, layers, ...,
heads / p, head_dim]``), the lengths and block tables shared, so layer
``i`` of rank ``r`` writes and reads its heads' rows in ``k[r, i]``, as
a device does in the JAX package's ``shard_map`` body.

Attention runs once a rank a layer on that rank's head shard, through
the engine's ``cache_attention_fn`` / ``paged_attention_fn`` (the
flash-decode kernel on the card, at H/p heads); an int8 dense layer runs
``quant_matmul_fn`` once a rank on that rank's weight shard. Its state
is :func:`~mpit_tpu_torch.serve.weights.shard_gpt2_params`'s.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    LayerNorm,
    QuantizedWeight,
    cache_update,
    cached_attention,
    paged_cached_attention,
    paged_scatter,
)
from mpit_tpu_torch.ops.quantized_matmul import quantized_matmul
from mpit_tpu_torch.parallel import megatron as M

__all__ = ["TPBlock", "TPDense", "TPGPT2"]


class TPDense(nn.Module):
    """One dense layer cut over ``ranks``: ``column`` (kernel ``[p, in,
    out/p]``, bias ``[p, out/p]``; replicated in, sharded out) or ``row``
    (kernel ``[p, in/p, out]``, bias ``[out]``; sharded in, replicated out
    after the rank-order sum). The arithmetic of the one-rank ``Dense``:
    a plain kernel casts x, kernel and bias to ``dtype``; an int8 kernel
    (q rank-stacked; its scales rank-stacked where the rows are cut, held
    once where they are not) runs ``quant_matmul_fn`` once a rank and
    adds the f32 bias before the cast to ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None, *, ranks: int, cut: str,
                 quant_matmul_fn=None):
        super().__init__()
        p = ranks
        self.dtype, self.cut, self.matmul_fn = dtype, cut, quant_matmul_fn
        shape = (p, d_in, d_out // p) if cut == "column" else (p, d_in // p, d_out)
        if quant_matmul_fn is None:
            self.kernel = nn.Parameter(torch.empty(shape, device=device))
        else:
            scale = (d_in, 1) if cut == "column" else (p, d_in // p, 1)
            self.kernel = QuantizedWeight(shape, scale, device)
        bias = (p, d_out // p) if cut == "column" else (d_out,)
        self.bias = nn.Parameter(torch.zeros(bias, device=device))

    def forward(self, x):
        dt = self.dtype
        layer = M.column_parallel_dense if self.cut == "column" else M.row_parallel_dense
        if isinstance(self.kernel, QuantizedWeight):
            y = layer(x, self.kernel.tensor(), self.bias, matmul_fn=self.matmul_fn)
            return y.to(dt)
        return layer(x.to(dt), self.kernel.to(dt), self.bias.to(dt))


class TPBlock(nn.Module):
    """A GPT-2 block over ``ranks`` (``_tp_forward_body``'s layer).
    ``layer_cache`` as in :class:`~mpit_tpu_torch.models.gpt2.Block`,
    with every K/V buffer rank-stacked ``[p, ..., heads / p, head_dim]``."""

    def __init__(self, cfg: GPT2Config, device=None, quantized=False, *, ranks: int):
        super().__init__()
        self.cfg, self.ranks = cfg, ranks
        d = cfg.d_model
        qmm = None
        if quantized:
            qmm = cfg.quant_matmul_fn or functools.partial(
                quantized_matmul, block_rows=cfg.quant_block_rows or None
            )
        dense = functools.partial(TPDense, dtype=cfg.dtype, device=device, ranks=ranks,
                                  quant_matmul_fn=qmm)
        self.ln1 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.qkv = dense(d, 3 * d, cut="column")
        self.proj = dense(d, d, cut="row")
        self.ln2 = LayerNorm(d, cfg.ln_out_dtype, device)
        self.fc = dense(d, cfg.ff_dim, cut="column")
        self.out = dense(cfg.ff_dim, d, cut="row")

    def _attend(self, r: int, q, k, v, layer_cache):
        """Rank ``r``'s heads: write its new K/V rows into its shard of
        the layer's buffers and attend against them."""
        cfg = self.cfg
        if layer_cache is None:
            return cfg.attention_fn(q, k, v, causal=True)
        if len(layer_cache) == 5:
            k_pool, v_pool, lengths, block_table, write_idx = layer_cache
            paged_scatter(k_pool[r], k, write_idx)
            paged_scatter(v_pool[r], v, write_idx)
            attn_fn = cfg.paged_attention_fn or paged_cached_attention
            return attn_fn(q.contiguous(), k_pool[r], v_pool[r], lengths, block_table)
        k_cache, v_cache, lengths, valid = layer_cache
        cache_update(k_cache[r], k, lengths, valid)
        cache_update(v_cache[r], v, lengths, valid)
        attn_fn = cfg.cache_attention_fn or cached_attention
        return attn_fn(q.contiguous(), k_cache[r], v_cache[r], lengths)

    def forward(self, x, layer_cache=None):
        cfg, p = self.cfg, self.ranks
        heads = cfg.num_heads // p
        split = lambda t: t.reshape(*t.shape[:-1], heads, cfg.head_dim)  # noqa: E731
        q, k, v = (split(t) for t in self.qkv(self.ln1(x)).chunk(3, dim=-1))
        attn = torch.stack([self._attend(r, q[r], k[r], v[r], layer_cache) for r in range(p)])
        x = x + self.proj(attn.reshape(*attn.shape[:-2], cfg.d_model // p))
        h = F.gelu(self.fc(self.ln2(x)), approximate="tanh")
        return x + self.out(h)


class TPGPT2(GPT2):
    """GPT-2 over ``ranks`` tensor-parallel ranks on one device: the
    replicated parts of :class:`~mpit_tpu_torch.models.gpt2.GPT2` around
    :class:`TPBlock` s, the one block of tensor-parallel serving and
    training. Loaded (from
    :func:`~mpit_tpu_torch.serve.weights.shard_gpt2_params`), never
    initialised. Its cache buffers are rank-stacked: layer ``i`` is
    ``buf[:, i]``.

    ``vocab_parallel`` (training, the pjit tier's vocab-cut ``wte``): the
    tied table is ``[ranks, V_pad/ranks, D]``
    (:func:`~mpit_tpu_torch.parallel.megatron.vocab_parallel_embed`) and
    ``forward(tokens, targets=)`` returns the per-token losses of the
    unfused vocab-parallel head
    (:func:`~mpit_tpu_torch.parallel.megatron.vocab_parallel_xent`);
    such a model has no cache path and no logits."""

    def __init__(self, cfg: GPT2Config, ranks: int, *, device=None, quantized=False,
                 vocab_parallel: bool = False):
        super().__init__(cfg, device=device, quantized=quantized,
                         make_block=functools.partial(TPBlock, ranks=ranks))
        if cfg.num_heads % ranks:
            raise ValueError(
                f"num_heads ({cfg.num_heads}) must divide by the {ranks} model ranks: each "
                "rank runs whole heads"
            )
        self.ranks = ranks
        self.vocab_parallel = vocab_parallel
        if vocab_parallel:
            if quantized or not cfg.tie_head:
                raise ValueError("the vocab-parallel head is the tied f32 table's")
            rows = -(-cfg.vocab_size // ranks)
            self.wte = nn.Parameter(torch.empty(ranks, rows, cfg.d_model, device=device))

    def embed(self, tokens):
        if self.vocab_parallel:
            return M.vocab_parallel_embed(self.wte, tokens)
        return super().embed(tokens)

    def head_xent(self, x, targets):
        if self.vocab_parallel:
            return M.vocab_parallel_xent(x, self.wte, targets, self.cfg.vocab_size,
                                         compute_dtype=self.cfg.head_dtype)
        return super().head_xent(x, targets)

    def forward(self, tokens, cache=None, paged_cache=None, return_hidden=False,
                targets=None, positions=None):
        if self.vocab_parallel and targets is None:
            raise ValueError("a vocab-parallel model trains: pass targets=")
        return super().forward(tokens, cache, paged_cache, return_hidden, targets, positions)

    def cache_layer(self, buf, i: int):
        return buf[:, i]

    def write_pool(self, buf):
        return buf[0, 0]
