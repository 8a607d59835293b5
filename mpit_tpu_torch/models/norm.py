"""BatchNorm for the ResNet: the port of
:class:`mpit_tpu.models.norm.ScaleShiftBatchNorm`, and of flax's
``nn.BatchNorm``, which the JAX package keeps as its parity oracle
(``--bn-impl flax``).

Both take an NCHW tensor (a channels-last view, as the convnets keep
their activations) and reduce over every axis but the channel, axis 1.
Both hold flax's variables under flax's names: the parameters ``scale``
and ``bias`` and the buffers ``mean`` and ``var`` (the ``batch_stats``
collection), all float32, the running averages initialised to 0 and 1.
The mode is the explicit ``train`` keyword of ``forward`` (JAX's
``use_running_average`` is ``not train``):

- ``train=True``: the batch's statistics normalise, and the running
  averages take one momentum step toward them (``m·ra + (1 - m)·stat``,
  biased variance), in place and outside autograd;
- ``train=False``: the running averages normalise; nothing changes.

The two modules differ only in the order of their arithmetic, as their
JAX forms do:

- :class:`ScaleShiftBatchNorm`: one pass of ``Σx`` and ``Σx²`` in f32,
  ``a = rsqrt(var + ε)·scale`` and ``b = bias − mean·a`` in f32, then
  ``x·a + b`` in the output dtype;
- :class:`BatchNorm`: flax's ``mean(x)`` and ``mean(x²)`` in f32, then
  ``((x − mean)·(rsqrt(var + ε)·scale) + bias)`` in f32 and one cast to
  the output dtype.

Cross-replica statistics (JAX's ``axis_name``) are refused: the port's
ranks run their forwards one after another in one process, so no rank's
forward can see another's sums while it runs. The ResNet does not use
them; its statistics are averaged over the ranks after the step
(:func:`mpit_tpu_torch.train.make_train_step` with ``stateful=True``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BatchNorm", "ScaleShiftBatchNorm"]


class _Norm(nn.Module):
    """The variables, the statistics and the running-average update the
    two forms share; ``_apply_stats`` is each form's normalisation."""

    def __init__(self, channels: int, *, momentum: float = 0.99, epsilon: float = 1e-5,
                 dtype=None, axis_name: str | None = None, scale_init: float = 1.0,
                 device=None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                f"axis_name={axis_name!r}: cross-replica BatchNorm statistics need every "
                "rank's forward at once, and the port's ranks run one after another; "
                "the ResNet averages its statistics over the ranks after each step"
            )
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.full((channels,), float(scale_init), device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def _batch_stats(self, xf, dims, n):
        raise NotImplementedError

    def _apply_stats(self, x, mean, var, out_dtype):
        raise NotImplementedError

    def forward(self, x, *, train: bool):
        out_dtype = self.dtype or x.dtype
        if not train:
            return self._apply_stats(x, self.mean, self.var, out_dtype)
        dims = [d for d in range(x.dim()) if d != 1]
        mean, var = self._batch_stats(x.float(), dims, x.numel() // x.shape[1])
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return self._apply_stats(x, mean, var, out_dtype)

    @staticmethod
    def _channel(t, ndim: int):
        """A ``[C]`` vector shaped to broadcast over axis 1 of an
        ``ndim``-dimensional tensor."""
        return t.view(-1, *([1] * (ndim - 2)))


class ScaleShiftBatchNorm(_Norm):
    """BatchNorm with one-pass sufficient statistics and one scale-shift
    in the output dtype (``dtype``, default the input's): the port of the
    JAX package's ``ScaleShiftBatchNorm``. ``scale_init`` is the value
    ``scale`` starts at (0 for a residual block's last norm)."""

    def _batch_stats(self, xf, dims, n):
        s1 = xf.sum(dims)
        s2 = (xf * xf).sum(dims)
        mean = s1 / n
        # Biased variance, clipped: E[x²] − E[x]² can go slightly negative.
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        return mean, var

    def _apply_stats(self, x, mean, var, out_dtype):
        a = torch.rsqrt(var + self.epsilon) * self.scale
        b = self.bias - mean * a
        a, b = self._channel(a, x.dim()), self._channel(b, x.dim())
        return x.to(out_dtype) * a.to(out_dtype) + b.to(out_dtype)


class BatchNorm(_Norm):
    """flax's ``nn.BatchNorm`` (fast variance, f32 statistics, float32
    parameters): the JAX package's parity oracle, selected by
    ``--bn-impl flax``."""

    def _batch_stats(self, xf, dims, n):
        mean = xf.mean(dims)
        mean2 = (xf * xf).mean(dims)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return mean, var

    def _apply_stats(self, x, mean, var, out_dtype):
        nd = x.dim()
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - self._channel(mean, nd)) * self._channel(mul, nd) + self._channel(self.bias, nd)
        return y.to(out_dtype)
