"""flax-semantics layers and initialisers shared by the port's models,
and the converter that carries a JAX convnet's weights across.

- :func:`lecun_normal_` — flax's ``lecun_normal``: a normal truncated at
  two standard deviations, variance ``1 / fan_in``;
- :class:`Conv` — flax ``nn.Conv`` on NCHW tensors: kernel stored OIHW
  (PyTorch's layout; flax keeps HWIO), zero bias (or none, with
  ``use_bias=False``), symmetric or flax's per-side padding, input,
  kernel and bias cast to ``dtype`` first and the bias added after the
  rounded convolution, as flax adds it;
- :class:`Dense` — flax ``nn.Dense``: kernel stored ``[in, out]`` as
  flax stores it (as the GPT-2 model does), ``y = x @ kernel + bias``
  with the same casts;
- :func:`params_from_jax` — a flax convnet tree (``Conv_<i>`` /
  ``Dense_<i>``, nested as the ResNet's ``Bottleneck_<i>/Conv_<j>``) and
  its ``batch_stats`` as a model's ``state_dict``: conv kernels HWIO →
  OIHW, everything else as it is. The convnets flatten their last
  feature map in NHWC order, as JAX does, so the first dense layer's
  rows need no permutation.

Parameter names are the flax tree's paths with ``.`` for ``/``
(``Conv_0.kernel``), so :class:`~mpit_tpu_torch.opt.sharded.FlatLayout`
orders them as JAX's ``ravel_pytree`` orders its leaves (``bias`` before
``kernel``, ``Conv_*`` before ``Dense_*``, ``Bottleneck_10`` before
``Bottleneck_2``: the keys sort as strings at every level) and the
ZeRO-1 shards fall on JAX's leaf boundaries. Within a conv kernel the
elements are in OIHW order, JAX's in HWIO.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Conv", "Dense", "flatten_tree", "init_layers", "lecun_normal_", "params_from_jax",
]


def lecun_normal_(w: torch.Tensor, generator, fan_in: int | None = None) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at two
    standard deviations, scaled so the variance is ``1 / fan_in``
    (default ``w.shape[0]``, the ``[in, out]`` kernel's fan-in)."""
    fan_in = w.shape[0] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` (square kernel) on NCHW tensors: ``conv(x,
    kernel) + bias``, kernel ``[out, in, k, k]``. ``padding`` is one
    int for every side, or flax's ``((top, bottom), (left, right))``
    (the ResNet's space-to-depth stem pads ``((1, 2), (1, 2))``).
    ``use_bias=False`` leaves the bias out, as flax does: no parameter."""

    def __init__(self, d_in: int, d_out: int, k: int, *, stride: int = 1, padding=0,
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        if isinstance(padding, int):
            self.padding, self.pad = padding, None
        else:
            (top, bottom), (left, right) = padding
            self.padding, self.pad = 0, (left, right, top, bottom)
        self.kernel = nn.Parameter(torch.empty(d_out, d_in, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if use_bias else None

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.kernel.data, generator, fan_in=math.prod(self.kernel.shape[1:]))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        y = F.conv2d(x, self.kernel.to(dt), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel ``[in, out]``."""

    def __init__(self, d_in: int, d_out: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.kernel.data, generator)
        self.bias.data.zero_()

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def init_layers(model: nn.Module, generator) -> None:
    """Draw every :class:`Conv` and :class:`Dense` of ``model`` from
    ``generator``, in module order."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            mod.reset_parameters(generator)


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested dicts → ``/``-joined keys; an already flat dict passes."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path + "/"))
        else:
            out[path] = v
    return out


def params_from_jax(params: Mapping, model: nn.Module,
                    batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """The flax param tree of a convnet (nested, or ``/``-joined flat)
    as ``model``'s ``state_dict``, float32 CPU tensors: conv kernels
    HWIO → OIHW, dense kernels, biases and norm vectors as they are.
    ``batch_stats`` (the ResNet's collection of the same name) fills the
    model's buffers, the norms' ``mean`` and ``var``. Raises, naming the
    leaf, where the tree and the model part."""
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    leaves = flatten_tree(params)
    if batch_stats is not None:
        want.update({n: tuple(b.shape) for n, b in model.named_buffers()})
        leaves.update(flatten_tree(batch_stats))
    state = {}
    for path, leaf in leaves.items():
        name = path.replace("/", ".")
        arr = np.array(leaf, dtype=np.float32)  # a copy: the tensor may be written
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        if name not in want:
            raise ValueError(f"{path}: no such parameter in {type(model).__name__}")
        if arr.shape != want[name]:
            raise ValueError(f"{path}: shape {arr.shape} (port layout), the model's {want[name]}")
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(want) - set(state))
    if missing:
        raise ValueError(f"the tree lacks {missing}")
    return state
