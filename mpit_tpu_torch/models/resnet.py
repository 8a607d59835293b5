"""ResNet-50: the sync-allreduce, sharded-goo workload (baseline config
#4). The port of :class:`mpit_tpu.models.resnet.ResNet50`.

Bottleneck v1.5 (the stride on the 3×3), every block's last norm with
its ``scale`` starting at zero, a 1×1 projection shortcut where a block
changes the shape, a 3×3/2 max pool padded with −inf after the stem,
the mean pool in float32 and a float32 ``Dense`` head. Convolutions
compute in ``dtype`` (bf16 by default) with float32 parameters, the
norms in ``norm_dtype`` with float32 statistics (:mod:`.norm`).

Two stems:

- ``s2d`` (the default): a 2×2 space-to-depth (:func:`space_to_depth`,
  ``[B, 224, 224, 3] → [B, 112, 112, 12]``, channel ``(dy·2 + dx)·C +
  c``) and a 4×4 stride-1 conv padded ``((1, 2), (1, 2))``;
- ``conv7``: the classic 7×7 stride-2 conv padded 3.

Images come NHWC, as the JAX package feeds them; the model permutes
them to an NCHW view (channels-last memory, which cuDNN takes as is) and
keeps that view to the pool, so the converter permutes nothing but the
conv kernels. Module names are flax's: ``Conv_0``, the stem's norm,
``Bottleneck_<i>`` (each ``Conv_<j>`` and norm ``<j>``, ``j`` 3 for the
projection) and ``Dense_0``; a norm is ``ScaleShiftBatchNorm_<i>``, or
``BatchNorm_<i>`` with ``norm="flax"``, as in JAX. ``stage_sizes``
shrinks the depth for tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.layers import Conv, Dense, init_layers
from mpit_tpu_torch.models.norm import BatchNorm, ScaleShiftBatchNorm

__all__ = ["NORMS", "Bottleneck", "ResNet50", "space_to_depth"]

# --bn-impl -> the norm module.
NORMS = {"scale_shift": ScaleShiftBatchNorm, "flax": BatchNorm}


def space_to_depth(x):
    """NHWC ``[B, H, W, C]`` → ``[B, H/2, W/2, 4C]``, the 2×2 cell's
    pixel ``(dy, dx)`` at channels ``(dy·2 + dx)·C + c``: JAX's
    ``reshape(b, h/2, 2, w/2, 2, c).transpose(0, 1, 3, 2, 4, 5)``."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"stem='s2d' needs even input H/W (got {h}x{w}); use an even --train-size "
            "or stem='conv7'"
        )
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class Bottleneck(nn.Module):
    """``1×1 → 3×3 (stride) → 1×1 (4·filters)``, each conv followed by a
    norm (ReLU after the first two), the residual added before the last
    ReLU. ``forward(x, *, train)`` on an NCHW view."""

    def __init__(self, d_in: int, filters: int, strides: int = 1, *, dtype=torch.bfloat16,
                 norm=ScaleShiftBatchNorm, norm_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.norm_names = []
        d_out = 4 * filters
        convs = [(d_in, filters, 1, 1, 0), (filters, filters, 3, strides, 1),
                 (filters, d_out, 1, 1, 0)]
        if d_in != d_out or strides != 1:  # the projection shortcut
            convs.append((d_in, d_out, 1, strides, 0))
        for j, (cin, cout, k, s, pad) in enumerate(convs):
            setattr(self, f"Conv_{j}", Conv(cin, cout, k, stride=s, padding=pad, use_bias=False,
                                            dtype=dtype, device=device))
            name = f"{norm.__name__}_{j}"
            setattr(self, name, norm(cout, dtype=norm_dtype, scale_init=0.0 if j == 2 else 1.0,
                                     device=device))
            self.norm_names.append(name)
        self.project = len(convs) == 4

    def forward(self, x, *, train: bool):
        n0, n1, n2, *n3 = (getattr(self, n) for n in self.norm_names)
        y = F.relu(n0(self.Conv_0(x), train=train))
        y = F.relu(n1(self.Conv_1(y), train=train))
        y = n2(self.Conv_2(y), train=train)
        residual = n3[0](self.Conv_3(x), train=train) if self.project else x
        return F.relu(residual + y)


class ResNet50(nn.Module):
    """``forward(x, *, train)``: ``x [B, H, W, 3]`` NHWC → logits ``[B,
    num_classes]`` float32. ``train=True`` normalises with
    the batch's statistics and steps every norm's running averages;
    ``train=False`` normalises with the running averages. ``norm`` is
    ``scale_shift`` or ``flax`` (:data:`NORMS`). ``generator`` (a CPU
    ``torch.Generator``) draws flax's initialisation (lecun-normal
    kernels) on the CPU before the model moves to ``device``; without
    one the parameters are left for a ``load_state_dict``."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 stage_sizes=(3, 4, 6, 3), norm_dtype=torch.bfloat16, stem: str = "s2d",
                 norm: str = "scale_shift", *, device=None, generator=None):
        super().__init__()
        if stem not in ("s2d", "conv7"):
            raise ValueError(f"stem must be 's2d' or 'conv7', got {stem!r}")
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {sorted(NORMS)}, got {norm!r}")
        norm_cls = NORMS[norm]
        self.num_classes, self.dtype, self.stem = num_classes, dtype, stem
        dev = "cpu" if generator is not None else device
        if stem == "s2d":
            self.Conv_0 = Conv(12, 64, 4, padding=((1, 2), (1, 2)), use_bias=False, dtype=dtype,
                               device=dev)
        else:
            self.Conv_0 = Conv(3, 64, 7, stride=2, padding=3, use_bias=False, dtype=dtype,
                               device=dev)
        self.stem_norm = f"{norm_cls.__name__}_0"
        setattr(self, self.stem_norm, norm_cls(64, dtype=norm_dtype, device=dev))
        self.blocks = []
        d_in, i = 64, 0
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"Bottleneck_{i}"
                setattr(self, name, Bottleneck(d_in, 64 * 2**stage, strides, dtype=dtype,
                                               norm=norm_cls, norm_dtype=norm_dtype, device=dev))
                self.blocks.append(name)
                d_in, i = 4 * 64 * 2**stage, i + 1
        self.Dense_0 = Dense(d_in, num_classes, dtype=torch.float32, device=dev)
        if generator is not None:
            init_layers(self, generator)
            self.to(device)

    def forward(self, x, *, train: bool):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x)
        x = self.Conv_0(x.permute(0, 3, 1, 2))
        x = F.relu(getattr(self, self.stem_norm)(x, train=train))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf
        for name in self.blocks:
            x = getattr(self, name)(x, train=train)
        x = x.float().mean(dim=(2, 3))
        return self.Dense_0(x)
