"""Tensor parallelism with hand-placed collectives: the port of
:mod:`mpit_tpu.parallel.megatron` (Megatron-LM, arXiv:1909.08053; the
sequence-parallel refinement, arXiv:2205.05198).

The JAX functions run inside ``shard_map`` over the ``model`` axis and
see one device's shard of each weight. The port runs the ranks of a
:class:`~mpit_tpu_torch.comm.World` from one process, as a rank loop:

- a **sharded** tensor is rank-stacked, ``[p, ...]``, row ``r`` being
  rank ``r``'s shard (the column-parallel outputs, the head shards, the
  sequence shards under sequence parallelism, and every cut weight);
- a **replicated** tensor is held once, without a rank dimension: every
  rank would compute it alike, so the World computes it once (the
  residual stream, the LayerNorms, the row-parallel outputs after their
  sum);
- ``lax.psum`` is :func:`~mpit_tpu_torch.comm.collectives.rank_sum`, the
  ranks added in rank order.

A block's weights are its ``state_dict`` (keys ``qkv.kernel``,
``ln1.scale``, ...; ``<kernel>.q`` and ``<kernel>.scale`` for an int8
kernel). :func:`shard_block` cuts one into each rank's shard as
``tp_block_specs`` places them, :func:`join_block` joins the shards, and
:func:`stack_block` lays the shards out rank-stacked, the form the
functions here take. An int8 kernel (a
:class:`~mpit_tpu_torch.ops.quantized_matmul.QuantizedTensor` of
rank-stacked ``q``) runs ``matmul_fn``, by default
:func:`~mpit_tpu_torch.ops.quantized_matmul.quantized_matmul` (the CUDA
kernel on the card, once a rank, on that rank's shard). Its scales
follow the kernel's rows: a column shard keeps every row, so its scales
are replicated (held once, ``[D, 1]``); a row shard cuts the rows, so
its scales are cut with them (``[p, F/p, 1]``).

Every function trains through autograd over the rank loop: the
row-parallel sum's gradient reaches every rank's partial, and the
gradients of a replicated input that several ranks read (the
column-parallel all-reduce of dx) accumulate into it.

The vocab-parallel head (:func:`vocab_parallel_embed`,
:func:`vocab_parallel_xent`) is the counterpart of the GSPMD tier's
vocab-cut ``wte``: ``wte`` ``[p, V_pad/p, D]``, ``V_pad`` the vocabulary
rounded up to a multiple of ``p``, the pad rows zero and never read.
JAX's rule cuts ``wte`` over the vocabulary unpadded, which no even
``p`` does at GPT-2's 50257 (ROADMAP.md §C); with a ``p`` that divides
the vocabulary the layouts are equal.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.ops.quantized_matmul import QuantizedTensor, quantized_matmul

__all__ = [
    "block_cut",
    "column_parallel_dense",
    "join_block",
    "layernorm",
    "repack_qkv",
    "row_parallel_dense",
    "shard_block",
    "stack_block",
    "tp_attention",
    "tp_mlp",
    "tp_transformer_block",
    "unpack_qkv",
    "vocab_parallel_embed",
    "vocab_parallel_xent",
]

_COLUMN = ("qkv", "fc")  # column-parallel: the output features are cut
_ROW = ("proj", "out")  # row-parallel: the contraction rows are cut


def _rank_shard(kernel, r: int):
    """Rank ``r``'s shard of a rank-stacked kernel: ``kernel[r]``, or for
    an int8 kernel its ``q[r]`` with its scales (``scale[r]`` where they
    are cut, the whole ``scale`` where they are replicated)."""
    if not isinstance(kernel, QuantizedTensor):
        return kernel[r]
    scale = kernel.scale[r] if kernel.scale.dim() == kernel.q.dim() else kernel.scale
    return QuantizedTensor(q=kernel.q[r], scale=scale)


def _shard_matmul(x, kernel, r: int, matmul_fn):
    w = _rank_shard(kernel, r)
    return matmul_fn(x, w) if isinstance(w, QuantizedTensor) else x @ w


def column_parallel_dense(x, kernel, bias=None, *, matmul_fn: Callable = quantized_matmul):
    """``y_r = x @ W_r (+ b_r)``: the output feature-sharded, no
    communication. ``x`` ``[..., D]`` replicated; ``kernel`` ``[p, D,
    F/p]`` (or int8 with replicated ``[D, 1]`` scales); ``bias`` ``[p,
    F/p]`` or None. Returns ``[p, ..., F/p]``."""
    ys = []
    for r in range(kernel.shape[0]):
        y = _shard_matmul(x, kernel, r, matmul_fn)
        ys.append(y if bias is None else y + bias[r])
    return torch.stack(ys)


def row_parallel_dense(
    x, kernel, bias=None, *, reduce: str = "psum", matmul_fn: Callable = quantized_matmul
):
    """The closing half: ``y = Σ_r x_r @ W_r (+ b)``. ``x`` ``[p, ...,
    F/p]`` feature-sharded; ``kernel`` ``[p, F/p, D]`` (or int8 with
    ``[p, F/p, 1]`` scales). ``reduce="psum"`` returns the replicated sum
    ``[..., D]``; ``"scatter"`` the sequence-sharded ``[p, ..., T/p, D]``
    (a reduce-scatter on the sequence dim, -2: the Megatron-SP exit).
    ``bias`` ``[D]`` is added after the reduction, so it counts once."""
    if reduce not in ("psum", "scatter"):
        raise ValueError(f"reduce must be 'psum' or 'scatter', got {reduce!r}")
    partial = torch.stack(
        [_shard_matmul(x[r], kernel, r, matmul_fn) for r in range(kernel.shape[0])]
    )
    if reduce == "psum":
        y = C.rank_sum(partial)
    else:
        y = C.reduce_scatter(partial, scatter_axis=-2)
    return y if bias is None else y + bias


def _gather_sequence(x):
    """The Megatron-SP entry: ``[p, B, T/p, D]`` sequence shards → the
    whole ``[B, T, D]``, replicated (a tiled all-gather on dim -2)."""
    return C.allgather(x, gather_axis=-2)[0]


def tp_mlp(x, fc_kernel, fc_bias, out_kernel, out_bias, *, sequence_parallel: bool = False,
           matmul_fn: Callable = quantized_matmul):
    """The Megatron MLP: column(fc) → gelu (tanh) → row(out). Plain TP:
    ``x`` ``[B, T, D]`` replicated in and out, one sum. Megatron-SP: ``x``
    ``[p, B, T/p, D]`` sequence-sharded in and out; the pair becomes
    all-gather → column → gelu → row → reduce-scatter."""
    if sequence_parallel:
        x = _gather_sequence(x)
    h = F.gelu(column_parallel_dense(x, fc_kernel, fc_bias, matmul_fn=matmul_fn),
               approximate="tanh")
    return row_parallel_dense(h, out_kernel, out_bias,
                              reduce="scatter" if sequence_parallel else "psum",
                              matmul_fn=matmul_fn)


def _split_heads(t, heads: int):
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def tp_attention(
    x, qkv_kernel, qkv_bias, proj_kernel, proj_bias, *, num_heads_local: int,
    attention_fn: Callable, sequence_parallel: bool = False, causal: bool = True,
    matmul_fn: Callable = quantized_matmul,
):
    """The Megatron attention half: column(qkv) → each rank's H/p heads →
    row(proj). ``qkv_kernel`` ``[p, D, 3·D/p]`` in :func:`repack_qkv`
    layout, so rank ``r``'s columns are its heads' q, k and v;
    ``attention_fn(q, k, v, causal=)`` runs once a rank on ``[B, T, H/p,
    Dh]``. Layouts of ``x`` as in :func:`tp_mlp`."""
    if sequence_parallel:
        x = _gather_sequence(x)
    qkv = column_parallel_dense(x, qkv_kernel, qkv_bias, matmul_fn=matmul_fn)
    q, k, v = (_split_heads(t, num_heads_local) for t in qkv.chunk(3, dim=-1))
    attn = torch.stack([attention_fn(q[r], k[r], v[r], causal=causal)
                        for r in range(qkv.shape[0])])
    attn = attn.reshape(*attn.shape[:-2], -1)  # [p, B, T, D/p]
    return row_parallel_dense(attn, proj_kernel, proj_bias,
                              reduce="scatter" if sequence_parallel else "psum",
                              matmul_fn=matmul_fn)


def layernorm(x, scale, bias, *, eps: float = 1e-6):
    """flax ``nn.LayerNorm(dtype=f32)``: f32 statistics and output, the
    one LayerNorm of every tensor-parallel block (the arithmetic of
    :class:`mpit_tpu_torch.models.gpt2.LayerNorm`)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, eps)


def _cast(w, dtype):
    return w if isinstance(w, QuantizedTensor) else w.to(dtype)


def _kernel(params: Mapping, mod: str):
    """A block's ``<mod>.kernel``: the tensor, or an int8 pair."""
    if f"{mod}.kernel.q" in params:
        return QuantizedTensor(q=params[f"{mod}.kernel.q"], scale=params[f"{mod}.kernel.scale"])
    return params[f"{mod}.kernel"]


def tp_transformer_block(
    params: Mapping, x, *, num_heads: int, attention_fn: Callable | None = None,
    sequence_parallel: bool = False, dtype=torch.bfloat16, causal: bool = True,
    matmul_fn: Callable = quantized_matmul,
):
    """One whole pre-LN GPT-2 block, tensor-parallel over the ranks of
    its rank-stacked weights (:func:`stack_block`; ``num_heads`` is the
    whole model's). ``x`` is the residual stream, ``[B, T, D]``
    replicated, or ``[p, B, T/p, D]`` sequence-sharded when
    ``sequence_parallel`` (the LayerNorms and residual adds then run on
    each shard; they are position-local). f32 LayerNorms, ``dtype``
    matmuls, tanh gelu, as ``models.gpt2.Block``."""
    p = params["qkv.kernel.q" if "qkv.kernel.q" in params else "qkv.kernel"].shape[0]
    if num_heads % p:
        raise ValueError(f"num_heads ({num_heads}) must divide by TP={p}")
    if attention_fn is None:
        from mpit_tpu_torch.models.gpt2 import default_attention as attention_fn
    w = lambda mod: _cast(_kernel(params, mod), dtype)  # noqa: E731
    b = lambda mod: params[f"{mod}.bias"].to(dtype)  # noqa: E731
    h = layernorm(x, params["ln1.scale"], params["ln1.bias"]).to(dtype)
    x = x + tp_attention(h, w("qkv"), b("qkv"), w("proj"), b("proj"),
                         num_heads_local=num_heads // p, attention_fn=attention_fn,
                         sequence_parallel=sequence_parallel, causal=causal,
                         matmul_fn=matmul_fn)
    h = layernorm(x, params["ln2.scale"], params["ln2.bias"]).to(dtype)
    return x + tp_mlp(h, w("fc"), b("fc"), w("out"), b("out"),
                      sequence_parallel=sequence_parallel, matmul_fn=matmul_fn)


def _permute_qkv(t, p: int, groups: tuple):
    dm = t.shape[-1] // 3
    return t.reshape(*t.shape[:-1], *groups, dm // p).transpose(-3, -2).reshape(t.shape)


def repack_qkv(params: Mapping, p: int) -> dict:
    """A block's fused qkv columns ``[q | k | v]`` reordered to ``[q_0 k_0
    v_0 | q_1 k_1 v_1 | ...]``, one group a rank (heads contiguous
    inside), so that a contiguous column cut hands rank ``r`` exactly its
    H/p heads' q, k and v. Permutes ``qkv.kernel`` (or an int8
    kernel's ``qkv.kernel.q``: its per-row scales do not move) and
    ``qkv.bias`` of a block state; :func:`unpack_qkv` inverts it."""
    return _permute_block(params, p, (3, p))


def unpack_qkv(params: Mapping, p: int) -> dict:
    """Inverse of :func:`repack_qkv`."""
    return _permute_block(params, p, (p, 3))


def _permute_block(params: Mapping, p: int, groups: tuple) -> dict:
    out = dict(params)
    for key in ("qkv.kernel", "qkv.kernel.q", "qkv.bias"):
        if key in params:
            out[key] = _permute_qkv(params[key], p, groups)
    return out


def block_cut(name: str) -> int | None:
    """The dimension of block leaf ``name`` that ``tp_block_specs`` cuts
    over the ranks, None where it is replicated: the column-parallel
    kernels on their output columns (their int8 scales replicated) and
    biases, the row-parallel kernels on their rows (their int8 scales
    with them); the LayerNorms and the row-parallel biases whole."""
    mod, _, leaf = name.partition(".")
    if mod in _COLUMN:
        return {"kernel": 1, "kernel.q": 1, "bias": 0}.get(leaf)
    if mod in _ROW:
        return {"kernel": 0, "kernel.q": 0, "kernel.scale": 0}.get(leaf)
    return None


def shard_block(params: Mapping, p: int) -> list[dict]:
    """A block's state (qkv in :func:`repack_qkv` layout) cut into its
    ``p`` ranks' shards, each a state of the same keys: a cut leaf's
    ``r``-th of ``p`` equal pieces (views), a replicated leaf whole."""
    shards = [{} for _ in range(p)]
    for name, t in params.items():
        dim = block_cut(name)
        if dim is not None and t.shape[dim] % p:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not divide by {p}")
        pieces = [t] * p if dim is None else t.chunk(p, dim=dim)
        for r in range(p):
            shards[r][name] = pieces[r]
    return shards


def join_block(shards: list) -> dict:
    """Inverse of :func:`shard_block`: the ranks' shards joined back into
    one block state (a replicated leaf is rank 0's)."""
    return {
        name: t if block_cut(name) is None
        else torch.cat([s[name] for s in shards], dim=block_cut(name))
        for name, t in shards[0].items()
    }


def stack_block(params: Mapping, p: int) -> dict:
    """A block's state laid out for the functions here: every cut leaf
    rank-stacked ``[p, ...]`` (row ``r`` rank ``r``'s shard), every
    replicated leaf held once."""
    shards = shard_block(params, p)
    return {
        name: t if block_cut(name) is None else torch.stack([s[name] for s in shards])
        for name, t in params.items()
    }


def _vocab_rows(vocab: int, p: int, rows: int, r: int) -> int:
    """How many of rank ``r``'s ``rows`` vocabulary rows are real (the
    rest pad the vocabulary to a multiple of ``p``)."""
    return min(max(vocab - r * rows, 0), rows)


def vocab_parallel_embed(wte, tokens):
    """The token embeddings ``[..., D]`` from the vocab-cut table ``wte``
    ``[p, V_pad/p, D]``: each rank looks up the tokens in its rows (zeros
    elsewhere), and the ranks' lookups are summed in rank order (one rank
    holds each token, so the sum is its row exactly). Held once."""
    rows = wte.shape[1]
    out = None
    for r in range(wte.shape[0]):
        local = tokens - r * rows
        inside = (local >= 0) & (local < rows)
        e = torch.where(inside[..., None], wte[r][local.clamp(0, rows - 1)], 0.0)
        out = e if out is None else out + e
    return out


def vocab_parallel_xent(h, wte, targets, vocab: int, *, compute_dtype=torch.float32):
    """Per-token cross entropy ``[...]`` f32 of the tied head over the
    vocab-cut ``wte`` ``[p, V_pad/p, D]``: each rank's logits ``h @
    wte_r[:real]ᵀ`` (operands rounded to ``compute_dtype``, products
    summed in f32, as the one-rank unfused head), the pad rows left out;
    ``lse`` from the max over the ranks' maxima and the rank-order sum of
    each rank's exponentials; the target's logit from the rank that holds
    it. ``h`` ``[..., D]`` replicated, ``targets`` ``[...]``."""
    p, rows = wte.shape[:2]
    hc = h.to(compute_dtype).float()
    logits = []
    for r in range(p):
        real = _vocab_rows(vocab, p, rows, r)
        logits.append(hc @ wte[r, :real].to(compute_dtype).float().T if real else None)
    live = [z for z in logits if z is not None]
    mx = torch.stack([z.amax(dim=-1) for z in live]).amax(dim=0).detach()
    sum_exp, picked = None, None
    for r, z in enumerate(logits):
        if z is None:
            continue
        e = torch.exp(z - mx[..., None]).sum(dim=-1)
        sum_exp = e if sum_exp is None else sum_exp + e
        local = targets.long() - r * rows
        inside = (local >= 0) & (local < z.shape[-1])
        t = z.gather(-1, local.clamp(0, z.shape[-1] - 1)[..., None])[..., 0]
        t = torch.where(inside, t, 0.0)
        picked = t if picked is None else picked + t
    return mx + torch.log(sum_exp) - picked
