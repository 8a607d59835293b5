"""LeNet: the MNIST workload (baseline configs #1 and #2). The port of
:class:`mpit_tpu.models.lenet.LeNet`.

The classic LeNet-5 shape on 28×28×1 images: conv 6@5×5 "SAME", ReLU,
average pool 2/2, conv 16@5×5 "VALID", ReLU, average pool 2/2, then
dense 400 → 120 → 84 → ``num_classes`` with ReLUs between. Images come
NHWC, as the JAX package feeds them; the model permutes them to an NCHW
view, and flattens its last 5×5×16 map back in NHWC order, so its
``Dense_0`` rows are JAX's. ``dtype`` is the compute type (parameters
stay float32); the last dense layer computes in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.layers import Conv, Dense, init_layers

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """``forward(x)``: ``x [B, 28, 28, 1]`` → logits ``[B, num_classes]``
    float32. ``generator`` (a CPU ``torch.Generator``) draws flax's
    initialisation (lecun-normal kernels, zero biases) on the CPU before
    the model moves to ``device``; without one the parameters are left
    for a ``load_state_dict``."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32, *, device=None,
                 generator=None):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        dev = "cpu" if generator is not None else device
        self.Conv_0 = Conv(1, 6, 5, padding=2, dtype=dtype, device=dev)
        self.Conv_1 = Conv(6, 16, 5, dtype=dtype, device=dev)
        self.Dense_0 = Dense(16 * 5 * 5, 120, dtype=dtype, device=dev)
        self.Dense_1 = Dense(120, 84, dtype=dtype, device=dev)
        self.Dense_2 = Dense(84, num_classes, dtype=torch.float32, device=dev)
        if generator is not None:
            init_layers(self, generator)
            self.to(device)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
