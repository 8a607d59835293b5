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
  numpy can read) as a ``state_dict`` for the port's model;
- :func:`load_gpt2_params` — the three together: ``(state, cfg)``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mpit_tpu_torch.models.gpt2 import GPT2Config

__all__ = [
    "expected_param_shapes",
    "infer_config",
    "load_dense",
    "load_gpt2_params",
    "params_from_jax",
    "validate_params",
]


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


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """Nested dicts → ``/``-joined keys; an already flat dict passes."""
    flat: dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def infer_config(
    params: Mapping, *, num_heads: int = 0, meta: Mapping | None = None
) -> GPT2Config:
    """The :class:`GPT2Config` of a dense param tree (nested or flat).
    Every geometry field except the head count follows from the shapes;
    the head count is ``num_heads``, else the checkpoint's ``meta``,
    else GPT-2's ``d_model / 64``."""
    flat = _flatten(params)
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
    got = {k: tuple(np.shape(v)) for k, v in _flatten(params).items()}
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


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX GPT-2 param tree as the port's ``state_dict``.

    ``params`` is the nested flax tree or its ``/``-joined flat form,
    with leaves numpy can read. Names map one to one
    (``block_<i>/qkv/kernel`` → ``blocks.<i>.qkv.kernel``) and layouts
    are kept: the port stores dense kernels ``[in, out]`` as flax does.
    Returns float32 CPU tensors."""
    state = {}
    for path, leaf in _flatten(params).items():
        parts = path.split("/")
        if parts[0].startswith("block_"):
            parts = ["blocks", parts[0][len("block_"):], *parts[1:]]
        arr = np.asarray(leaf, dtype=np.float32)
        state[".".join(parts)] = torch.from_numpy(arr.copy())
    return state


def load_gpt2_params(path: str, *, num_heads: int = 0):
    """Load a dense ``.npz`` for serving: ``(state, cfg)``, the model's
    ``state_dict`` (float32 CPU tensors) and the inferred, validated
    :class:`GPT2Config`. Optimizer moments and step are dropped."""
    params, meta = load_dense(path)
    cfg = infer_config(params, num_heads=num_heads, meta=meta)
    validate_params(cfg, params)
    return params_from_jax(params), cfg
