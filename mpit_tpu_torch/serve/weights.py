"""Weights for serving: the dense ``.npz`` checkpoint and the JAX param
tree, as the port's :class:`~mpit_tpu_torch.models.GPT2` state.

- :func:`expected_param_shapes` — the ``/``-joined leaf names and shapes
  of a dense GPT-2 param tree (``block_<i>/qkv/kernel``, ...), the
  on-disk key layout of the JAX package's ``train.convert.save_dense``;
- :func:`load_dense` — a numpy-only reader of that ``.npz``'s params
  and metadata;
- :func:`infer_config` / :func:`validate_params` — the geometry from the
  tree's shapes, and a precise diff when the tree deviates;
- :func:`params_from_jax` — the param tree (nested or flat, any arrays
  numpy can read, int8 weight-store leaves included) as a ``state_dict``
  for the port's model;
- :func:`load_gpt2_params` — the three together: ``(state, cfg)``;
- :func:`quantize_gpt2_params` / :func:`params_wire_bytes` — the int8
  weight store over a ``state_dict``, and the bytes a state occupies;
- :func:`shard_gpt2_params` — a state cut for the tensor-parallel
  model :class:`~mpit_tpu_torch.serve.tp.TPGPT2` (serving, and training
  with the vocab-cut table); :func:`join_gpt2_params` its inverse;
- :func:`draft_from_target` — a layer-truncated self-draft for
  speculative decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpit_tpu_torch.models.gpt2 import GPT2Config
from mpit_tpu_torch.models.layers import flatten_tree
from mpit_tpu_torch.ops.quantized_matmul import quantize_tensor
from mpit_tpu_torch.parallel import megatron as M

__all__ = [
    "draft_from_target",
    "expected_param_shapes",
    "infer_config",
    "join_gpt2_params",
    "load_dense",
    "load_gpt2_params",
    "params_from_jax",
    "params_wire_bytes",
    "quantize_gpt2_params",
    "register_param_store",
    "shard_gpt2_params",
    "validate_params",
]

# The dense layers of a block whose kernels the int8 store quantizes.
_QUANT_BLOCK_MODULES = ("qkv", "proj", "fc", "out")


def expected_param_shapes(cfg: GPT2Config) -> dict[str, tuple[int, ...]]:
    """``{leaf_path: shape}`` for a dense GPT-2 param tree, paths
    ``/``-joined."""
    d, ff, v = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    out: dict[str, tuple[int, ...]] = {
        "wte": (v, d),
        "wpe": (cfg.max_seq_len, d),
        "ln_f/scale": (d,),
        "ln_f/bias": (d,),
    }
    if not cfg.tie_head:
        out["head"] = (v, d)
    per_block = {
        "ln1/scale": (d,), "ln1/bias": (d,),
        "qkv/kernel": (d, 3 * d), "qkv/bias": (3 * d,),
        "proj/kernel": (d, d), "proj/bias": (d,),
        "ln2/scale": (d,), "ln2/bias": (d,),
        "fc/kernel": (d, ff), "fc/bias": (ff,),
        "out/kernel": (ff, d), "out/bias": (d,),
    }
    for i in range(cfg.num_layers):
        for leaf, shape in per_block.items():
            out[f"block_{i}/{leaf}"] = shape
    return out


def infer_config(
    params: Mapping, *, num_heads: int = 0, meta: Mapping | None = None
) -> GPT2Config:
    """The :class:`GPT2Config` of a dense param tree (nested or flat).
    Every geometry field except the head count follows from the shapes;
    the head count is ``num_heads``, else the checkpoint's ``meta``,
    else GPT-2's ``d_model / 64``."""
    flat = flatten_tree(params)
    vocab, d_model = flat["wte"].shape
    max_seq_len = flat["wpe"].shape[0]
    num_layers = len({k.split("/")[0] for k in flat if k.startswith("block_")})
    d_ff = flat["block_0/fc/kernel"].shape[1]
    meta = dict(meta or {})
    tie_head = "head" not in flat
    if "tie_head" in meta and bool(meta["tie_head"]) != tie_head:
        raise ValueError(
            f"checkpoint metadata says tie_head={bool(meta['tie_head'])} "
            f"but the param tree {'has no' if tie_head else 'has a'} "
            "separate head leaf: corrupt or mis-assembled checkpoint"
        )
    return GPT2Config(
        vocab_size=int(vocab),
        max_seq_len=int(max_seq_len),
        num_layers=int(num_layers),
        num_heads=int(num_heads)
        or int(meta.get("num_heads", 0))
        or max(int(d_model) // 64, 1),
        d_model=int(d_model),
        d_ff=int(d_ff),
        tie_head=tie_head,
    )


def validate_params(cfg: GPT2Config, params: Mapping) -> None:
    """Raise with a precise diff when ``params`` deviates from
    :func:`expected_param_shapes`."""
    expected = expected_param_shapes(cfg)
    got = {k: tuple(np.shape(v)) for k, v in flatten_tree(params).items()}
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    wrong = sorted(
        f"{k}: {got[k]} != {expected[k]}"
        for k in set(got) & set(expected)
        if got[k] != expected[k]
    )
    if missing or extra or wrong:
        raise ValueError(
            "dense checkpoint does not match the serve param contract: "
            f"missing={missing} extra={extra} shape-mismatch={wrong}"
        )


def load_dense(path: str) -> tuple[dict, dict]:
    """Read a dense ``.npz`` with numpy only: ``(params, meta)``, the
    nested param tree (keys ``p/['a']['b']``) and the recorded geometry
    (keys ``meta/<name>``, e.g. ``num_heads``). Optimizer moments and
    the step are skipped: serving is stateless."""
    params: dict = {}
    meta: dict = {}
    with np.load(path) as z:
        for key in z.files:
            head, _, rest = key.partition("/")
            if head == "meta":
                meta[rest] = z[key].item()
            elif head == "p":
                # Key paths are written as ['a']['b']; normalize to a/b.
                parts = rest.replace("']['", "/").strip("[']").split("/")
                node = params
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = z[key]
    return params, meta


def _cpu_tensor(path: str, leaf, dtype) -> torch.Tensor:
    """``leaf`` as a CPU tensor of numpy ``dtype``; a leaf that is not a
    numeric array raises with its path."""
    arr = np.asarray(leaf)
    if arr.dtype.kind in "OSU":  # None, strings, other objects
        raise ValueError(
            f"param leaf {path!r} is neither a numeric array nor a "
            f"quantized (.q, .scale) pair: {type(leaf).__name__}"
        )
    return torch.from_numpy(np.array(arr, dtype=dtype))


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX GPT-2 param tree as the port's ``state_dict``.

    ``params`` is the nested flax tree or its ``/``-joined flat form.
    Names map one to one (``block_<i>/qkv/kernel`` →
    ``blocks.<i>.qkv.kernel``) and layouts are kept: the port stores
    dense kernels ``[in, out]`` as flax does. Array leaves become
    float32 CPU tensors. A quantized leaf (anything with ``.q`` and
    ``.scale``, the JAX package's ``QuantizedTensor``) becomes
    ``<name>.q`` int8 and ``<name>.scale`` f32, bit for bit. Any other
    leaf raises with its path."""
    state = {}
    for path, leaf in flatten_tree(params).items():
        parts = path.split("/")
        if parts[0].startswith("block_"):
            parts = ["blocks", parts[0][len("block_"):], *parts[1:]]
        name = ".".join(parts)
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            state[f"{name}.q"] = _cpu_tensor(path + ".q", leaf.q, np.int8)
            state[f"{name}.scale"] = _cpu_tensor(
                path + ".scale", leaf.scale, np.float32
            )
        else:
            state[name] = _cpu_tensor(path, leaf, np.float32)
    return state


def _quantized_leaf(name: str) -> bool:
    """Whether the int8 store quantizes state entry ``name``: the dense
    kernels of every block, ``wte`` and an untied ``head``."""
    parts = name.split(".")
    if parts in (["wte"], ["head"]):
        return True
    return (
        len(parts) == 4 and parts[0] == "blocks"
        and parts[2] in _QUANT_BLOCK_MODULES and parts[3] == "kernel"
    )


def quantize_gpt2_params(state: Mapping) -> dict:
    """The int8 weight store over a GPT-2 ``state_dict``: every matmul
    weight — the ``qkv``/``proj``/``fc``/``out`` kernels, ``wte`` and an
    untied ``head`` — becomes ``<name>.q`` int8 and ``<name>.scale`` f32
    (one scale per row, the shared rounding contract), quantized on the
    CPU. Biases, LayerNorms and ``wpe`` stay as they are. Idempotent:
    entries already quantized pass through, as does everything else."""
    out = {}
    for name, val in state.items():
        if _quantized_leaf(name):
            qt = quantize_tensor(val.detach().cpu())
            out[f"{name}.q"], out[f"{name}.scale"] = qt.q, qt.scale
        else:
            out[name] = val
    return out


def params_wire_bytes(state: Mapping) -> float:
    """Device bytes a ``state_dict`` occupies. A quantized weight is
    stored as its ``.q`` and ``.scale`` entries, so summing every
    entry's bytes is the ``weight_wire_bytes`` rule: int8 plus one f32
    scale per row for the int8 store, the dtype's size for the rest."""
    return float(sum(t.numel() * t.element_size() for t in state.values()))


def _storage_key(t) -> tuple:
    """What identifies a tensor's memory: its storage's address and size
    (a view or a tied weight shares its parent's)."""
    st = t.untyped_storage()
    return (t.device.type, t.device.index, st.data_ptr(), st.nbytes())


def register_param_store(
    memledger, params: Mapping, *, subsystem: str = "weights", alias_of=None
) -> float:
    """Register one parameter store's device bytes with the memory
    ledger: one grant of the bytes of every distinct storage among
    ``params``' tensors (a ``state_dict``: an int8 store's ``.q`` and
    ``.scale`` entries, a tensor-parallel model's rank-stacked shards, a
    tied head counted once), under ``subsystem``. Tensors whose storage
    is one of ``alias_of``'s cost nothing: their bytes are on that
    store's line already. Returns the granted bytes; ``memledger=None``
    does nothing."""
    if memledger is None:
        return 0.0
    seen = {_storage_key(t) for t in (alias_of or {}).values()}
    total = 0
    for t in params.values():
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        total += key[3]
    memledger.register(subsystem, capacity_bytes=total)
    memledger.grant(subsystem, total, kind="param_store")
    return float(total)


def _blocks(state: Mapping) -> dict:
    """``{i: block i's state}`` of a GPT-2 state, keys relative to the
    block (``qkv.kernel``, ...)."""
    out: dict = {}
    for name, t in state.items():
        parts = str(name).split(".", 2)
        if parts[0] == "blocks":
            out.setdefault(int(parts[1]), {})[parts[2]] = t
    return out


def shard_gpt2_params(
    state: Mapping, p: int, *, quantize: bool = False, vocab_parallel: bool = False
) -> dict:
    """A GPT-2 ``state_dict`` as the tensor-parallel model over ``p``
    ranks loads it, in the JAX engine's order
    (``mpit_tpu/serve/engine.py:698-714``): each block's qkv repacked for
    ``p`` ranks (:func:`~mpit_tpu_torch.parallel.megatron.repack_qkv`);
    then, with ``quantize``, the whole state quantized
    (:func:`quantize_gpt2_params`: each kernel whole, so a column shard
    keeps its rows' scales, which quantizing the shards one by one would
    change); then each block cut and laid out rank-stacked
    (:func:`~mpit_tpu_torch.parallel.megatron.stack_block`). ``wte``,
    ``wpe``, ``ln_f`` and an untied ``head`` stay whole (replicated).

    Training (the pjit tier's working layout): ``vocab_parallel`` cuts
    ``wte`` over the vocabulary instead, padded with zero rows to a
    multiple of ``p``: ``[p, V_pad/p, D]``
    (:class:`~mpit_tpu_torch.serve.tp.TPGPT2`'s ``vocab_parallel``); the
    tier's step cuts it again over fsdp
    (:func:`mpit_tpu_torch.parallel.tp.fsdp_cut`).
    :func:`join_gpt2_params` inverts it."""
    if quantize and vocab_parallel:
        raise ValueError("the vocab-parallel table is the f32 training layout")
    blocks = {i: M.repack_qkv(b, p) for i, b in _blocks(state).items()}
    whole = {k: t for k, t in state.items() if not str(k).startswith("blocks.")}
    for i, b in blocks.items():
        whole.update({f"blocks.{i}.{k}": t for k, t in b.items()})
    if quantize:
        whole = quantize_gpt2_params(whole)
    out = {k: t for k, t in whole.items() if not str(k).startswith("blocks.")}
    for i, b in _blocks(whole).items():
        out.update({f"blocks.{i}.{k}": t for k, t in M.stack_block(b, p).items()})
    if vocab_parallel:
        wte = out["wte"]
        rows = -(-wte.shape[0] // p)
        out["wte"] = torch.nn.functional.pad(wte, (0, 0, 0, rows * p - wte.shape[0])).view(
            p, rows, wte.shape[1])
    return out


def join_gpt2_params(sharded: Mapping, p: int, *, vocab_size: int | None = None) -> dict:
    """Inverse of :func:`shard_gpt2_params` (unquantized): a vocab-cut
    ``wte`` joined and its pad rows dropped (``vocab_size``), each block's
    shards joined (:func:`~mpit_tpu_torch.parallel.megatron.join_block`)
    and its qkv unpacked: the one-rank ``state_dict`` (for checkpoints and
    for holding the tensor-parallel tiers against one rank)."""
    out = {k: t for k, t in sharded.items() if not str(k).startswith("blocks.")}
    if out["wte"].dim() == 3:
        out["wte"] = out["wte"].reshape(-1, out["wte"].shape[-1])[:vocab_size]
    for i, b in _blocks(sharded).items():
        shards = [{k: t if M.block_cut(k) is None else t[r] for k, t in b.items()}
                  for r in range(p)]
        joined = M.unpack_qkv(M.join_block(shards), p)
        out.update({f"blocks.{i}.{k}": t for k, t in joined.items()})
    return out


def load_gpt2_params(path: str, *, num_heads: int = 0):
    """Load a dense ``.npz`` for serving: ``(state, cfg)``, the model's
    ``state_dict`` (float32 CPU tensors) and the inferred, validated
    :class:`GPT2Config`. Optimizer moments and step are dropped."""
    params, meta = load_dense(path)
    cfg = infer_config(params, num_heads=num_heads, meta=meta)
    validate_params(cfg, params)
    return params_from_jax(params), cfg


def draft_from_target(params: Mapping, cfg: GPT2Config, num_layers: int):
    """A layer-truncated self-draft (``mpit_tpu.serve.weights.draft_from_target``):
    the first ``num_layers`` blocks of a target ``state_dict``, sharing
    its embeddings, final LayerNorm and head. The entries are the
    target's own tensors (references, not copies), and the draft passes
    every compatibility check of ``Engine(spec_k=...)`` by construction
    (the same vocabulary, a covering positional table). Returns
    ``(draft_state, draft_cfg)``."""
    if not 1 <= num_layers < cfg.num_layers:
        raise ValueError(
            f"draft_from_target needs 1 <= num_layers < target layers "
            f"({cfg.num_layers}), got {num_layers}: an equal-depth draft "
            f"costs what the target costs and speculation buys nothing"
        )
    out = {}
    for name, t in params.items():
        parts = str(name).split(".")
        if parts[0] == "blocks" and int(parts[1]) >= num_layers:
            continue
        out[name] = t
    return out, dataclasses.replace(cfg, num_layers=num_layers)
