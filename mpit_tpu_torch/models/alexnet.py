"""AlexNet: the ImageNet workload (baseline config #3 and the headline
benchmark). The port of :class:`mpit_tpu.models.alexnet.AlexNet`.

The torchvision-style shape: five convs (64@11×11 stride 4 pad 2,
192@5×5 pad 2, 384@3×3, 256@3×3, 256@3×3, pad 1), ReLUs, max pools
3/2 (VALID, floor) after convs 1, 2 and 5, then dense
``256·s·s`` → 4096 → 4096 → ``num_classes`` (``s`` the last map's side:
6 at 224). Images come NHWC, as the JAX package feeds them; the model
permutes them to an NCHW view (channels-last memory, which cuDNN takes
as is) and flattens the last map back in NHWC order, so ``Dense_0``'s
rows are JAX's. Compute runs in ``dtype`` (bf16 by default) with float32
parameters, each layer casting its input, kernel and bias as flax's
``dtype=`` does; the last dense layer computes in float32.
``dropout_rate`` (off by default, as in JAX) drops before each hidden
dense layer in a ``train=True`` forward, from the ``torch.Generator``
that forward is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.layers import Conv, Dense, init_layers

__all__ = ["AlexNet", "feature_side"]


def feature_side(image_size: int) -> int:
    """The side of AlexNet's last feature map for square images of
    ``image_size`` (6 at 224, 1 at 64)."""
    s = (image_size + 4 - 11) // 4 + 1
    for _ in range(3):  # the three 3/2 max pools (convs 2-5 keep the side)
        s = (s - 3) // 2 + 1
    if s < 1:
        raise ValueError(f"AlexNet needs images of at least 63 pixels, got {image_size}")
    return s


class AlexNet(nn.Module):
    """``forward(x, *, train=False, generator=None)``: ``x [B, S, S, 3]``
    → logits ``[B, num_classes]`` float32. ``generator`` at construction
    (a CPU ``torch.Generator``) draws flax's initialisation on the CPU
    before the model moves to ``device``."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16, dropout_rate: float = 0.0,
                 *, image_size: int = 224, device=None, generator=None):
        super().__init__()
        self.num_classes, self.dtype, self.dropout_rate = num_classes, dtype, dropout_rate
        dev = "cpu" if generator is not None else device
        convs = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
                 (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
        for i, (cin, cout, k, s, p) in enumerate(convs):
            setattr(self, f"Conv_{i}", Conv(cin, cout, k, stride=s, padding=p, dtype=dtype,
                                            device=dev))
        side = feature_side(image_size)
        self.Dense_0 = Dense(256 * side * side, 4096, dtype=dtype, device=dev)
        self.Dense_1 = Dense(4096, 4096, dtype=dtype, device=dev)
        self.Dense_2 = Dense(4096, num_classes, dtype=torch.float32, device=dev)
        if generator is not None:
            init_layers(self, generator)
            self.to(device)

    def _dropout(self, x, train: bool, generator):
        if not (self.dropout_rate and train):
            return x
        if generator is None:
            raise ValueError("a train-mode forward with dropout needs a torch.Generator")
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    def forward(self, x, *, train: bool = False, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 3, 2)
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = F.max_pool2d(F.relu(self.Conv_4(x)), 3, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self._dropout(x, train, generator)
        x = F.relu(self.Dense_0(x))
        x = self._dropout(x, train, generator)
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
