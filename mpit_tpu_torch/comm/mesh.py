"""The World of ranks: the port of :mod:`mpit_tpu.comm.mesh`.

The JAX package's ``init`` lays a named mesh over the devices and runs
one program per device under ``shard_map``. The port drives every rank
from one process: a :class:`World` names ``p`` ranks on its data axis
and the device of each (rank ``r`` on ``devices[r % len(devices)]``),
and the ranks' tensors are stacked along a leading rank dimension on
that device. On one GPU every rank shares ``cuda:0``; in the CPU tests
every rank shares the CPU. The ring kernels carry all ``p`` ranks in one
launch through a per-rank pointer table, so the same kernels serve
ranks on several cards later, one launch per card with peer pointers.

Only the data axis is ported; the model, seq, pipe, expert and fsdp
axes raise ``SystemExit`` naming the slice that brings them, and ranks
spread over more than one device raise naming the multi-card launch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

__all__ = ["DATA_AXIS", "World", "init"]

DATA_AXIS = "data"
_LATER_AXES = {
    "model": "the tensor-parallel slice (slice 6 of the port)",
    "fsdp": "the tensor-parallel slice (slice 6 of the port)",
    "seq": "the context-parallel tier, after the ring-collectives slice",
    "pipe": "the pipeline-parallel tier, after the ring-collectives slice",
    "expert": "the expert-parallel tier, after the ring-collectives slice",
}
_MULTI_CARD = "the ring's multi-card launch (with the tensor-parallel slice, 4 cards)"


@dataclasses.dataclass(frozen=True)
class World:
    """``p`` ranks on the data axis and the device of each.

    ``shape`` is ``{"data": p}``; ``devices`` the distinct devices the
    ranks are laid over, in order."""

    shape: Mapping[str, int]
    devices: tuple

    @property
    def num_devices(self) -> int:
        """The number of ranks (the JAX mesh's device count)."""
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def rank_device(self, rank: int) -> torch.device:
        return self.devices[rank % len(self.devices)]

    @property
    def device(self) -> torch.device:
        """The one device every rank lives on (the rank-stacked tensors'
        device). Ranks over several devices raise: their launch is a
        later slice's."""
        devs = {self.rank_device(r) for r in range(self.num_devices)}
        if len(devs) != 1:
            raise SystemExit(
                f"{self.num_devices} ranks over {len(devs)} devices: arrives with {_MULTI_CARD}"
            )
        return devs.pop()


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``cuda`` is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def init(
    axis_shapes: Mapping[str, int] | None = None,
    *,
    devices: Sequence | None = None,
) -> World:
    """Build a :class:`World` (the ``mpiT.Init()`` analogue).

    ``axis_shapes``: ``{"data": p}``; a size of ``-1`` is the device
    count; ``None`` is one rank per device. ``devices``: the devices to
    lay the ranks over, default every CUDA device (raises without one:
    pass ``devices=["cpu"]`` for the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device for the World; pass devices=['cpu'] to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("devices must name at least one device")
    shape = dict(axis_shapes) if axis_shapes else {DATA_AXIS: len(devices)}
    for axis in shape:
        if axis in _LATER_AXES:
            raise SystemExit(f"mesh axis {axis!r}: arrives with {_LATER_AXES[axis]}")
        if axis != DATA_AXIS:
            raise ValueError(f"unknown mesh axis {axis!r}; the port has {DATA_AXIS!r}")
    p = shape.get(DATA_AXIS, 1)
    if p == -1:
        p = len(devices)
    if p < 1:
        raise ValueError(f"the data axis needs at least one rank, got {p}")
    return World(shape={DATA_AXIS: p}, devices=devices)
