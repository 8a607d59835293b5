"""The World of ranks: the port of :mod:`mpit_tpu.comm.mesh`.

The JAX package's ``init`` lays a named mesh over the devices and runs
one program per device under ``shard_map``. The port drives every rank
from one process: a :class:`World` names its ranks on its axes and the
device of each (rank ``r`` on ``devices[r % len(devices)]``), and the
ranks' tensors are stacked along a leading rank dimension on that
device. On one GPU every rank shares ``cuda:0``; in the CPU tests every
rank shares the CPU. The ring kernels carry all ``p`` ranks in one
launch through a per-rank pointer table, so the same kernels serve
ranks on several cards later, one launch per card with peer pointers.

Four axes are ported: ``data`` (data parallelism), ``fsdp`` (the
parameter cut of FSDP, :mod:`mpit_tpu_torch.parallel.tp`), ``model``
(tensor parallelism, in serving and training) and ``seq`` (context
parallelism, :mod:`mpit_tpu_torch.parallel.cp`). Ranks are numbered
data-major in the order of JAX's axis names (``data``, ``fsdp``,
``model``, ``seq``; ``mpit_tpu/comm/mesh.py``), whatever order they are
given in: under ``{"data": d, "model": m}`` rank ``r`` is data index
``r // m`` and model index ``r % m``. The pipe and expert axes raise
``SystemExit`` naming the item that brings them, and ranks spread over
more than one device raise naming the multi-card launch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

__all__ = ["DATA_AXIS", "World", "init"]

DATA_AXIS = "data"
_AXES = (DATA_AXIS, "fsdp", "model", "seq")  # JAX's axis names, in its order
_LATER_AXES = {
    "pipe": "the pipeline-parallel tier (ROADMAP.md §A 10)",
    "expert": "the expert-parallel tier (ROADMAP.md §A 10)",
}
_MULTI_CARD = "the multi-card launch (ROADMAP.md §A 14, 4 cards)"


@dataclasses.dataclass(frozen=True)
class World:
    """The ranks on each axis and the device of each rank.

    ``shape`` maps each axis of the World to its size, in the order of
    :data:`_AXES` (data-major); ``devices`` the distinct devices the
    ranks are laid over, in order."""

    shape: Mapping[str, int]
    devices: tuple

    @property
    def num_devices(self) -> int:
        """The number of ranks (the JAX mesh's device count)."""
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def size(self, axis: str) -> int:
        """The axis' size, 1 for an axis the World does not have."""
        return self.shape.get(axis, 1)

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

    ``axis_shapes``: sizes of any of ``data``, ``fsdp``, ``model`` and
    ``seq`` (laid out data-major, whatever order they are given in); a
    size of ``-1``
    is the device count (one axis only); ``None`` is one rank per device
    on the data axis. ``devices``: the devices to lay the ranks over,
    default every CUDA device (raises without one: pass
    ``devices=["cpu"]`` for the CPU)."""
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
        if axis not in _AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; the port has {_AXES}")
    if list(shape.values()).count(-1) > (1 if len(shape) == 1 else 0):
        raise ValueError(f"a size of -1 (the device count) needs a one-axis mesh: {shape}")
    out = {}
    for axis in _AXES:
        if axis in shape:
            n = len(devices) if shape[axis] == -1 else shape[axis]
            if n < 1:
                raise ValueError(f"the {axis} axis needs at least one rank, got {n}")
            out[axis] = n
    return World(shape=out, devices=devices)
