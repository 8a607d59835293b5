"""GradSync: bucketed gradient synchronization over a World's ranks, the
port of :mod:`mpit_tpu.train.grad_sync`.

The sync strategy is a policy of the training step (``grad_sync=``):

- ``psum``    — the plain collectives of :mod:`mpit_tpu_torch.comm.collectives`
  (sums over the rank dimension in rank order), standing where XLA's
  stock collectives stand in the JAX package;
- ``ring``    — the ring reduce-scatter and all-gather of
  :mod:`mpit_tpu_torch.ops.ring_collectives`, one launch per bucket of
  the flat gradient, in order, on the current stream. The same sums as
  ``psum`` in another order, so equal to it up to f32 rounding;
- ``ring_q8`` — the ring with the int8 wire (per-chunk scales, f32
  accumulation): lossy by design, held to ``psum``'s loss curve within
  noise, not to its bits.

Every mode produces the same contiguous shard layout (rank ``r`` owns
``[r·S, (r+1)·S)`` of the ``p·128``-padded flat vector,
:func:`mpit_tpu_torch.opt.sharded.shard_of`): buckets are row ranges of
the shard (boundaries at multiples of 32 rows), and bucket ``b`` of
every rank's chunk goes to that chunk's owner, so the concatenation over
buckets is the contiguous shard. The kernels read each bucket's rows of
the flat buffers in place and write the result's rows in place; the
TPU's per-chunk tile pad of a ragged tail bucket is not materialized
(zero rows change neither a sum nor an amax), but the wire bytes are
charged at the planner's padded size, as the JAX package charges them.

All tensors are rank-stacked: ``[p, N]`` flat gradients, ``[p, S]``
shards.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.comm import collectives as C
from mpit_tpu_torch.opt.sharded import LANE, padded_len, shard_of
from mpit_tpu_torch.ops import ring_collectives as rc

__all__ = ["GRAD_SYNC_MODES", "GradSync"]

# Bucket boundaries are multiples of the int8 tile (32 rows), as in the
# JAX package, so the bucket plan is the same on both sides.
_BUCKET_ALIGN_ROWS = 32

GRAD_SYNC_MODES = ("psum", "ring", "ring_q8")


class GradSync:
    """Bucketed gradient-sync policy over ``world``'s ranks (see the
    module docstring). ``bucket_mb``: target bucket size in MB of f32
    elements; one ring launch per bucket and collective. Ignored for
    ``psum``."""

    def __init__(self, world, mode: str = "psum", *, bucket_mb: float = 4.0):
        if mode not in GRAD_SYNC_MODES:
            raise ValueError(f"grad_sync must be one of {GRAD_SYNC_MODES}, got {mode!r}")
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
        self.world = world
        self.mode = mode
        self.bucket_mb = float(bucket_mb)

    @property
    def quantized(self) -> bool:
        return self.mode == "ring_q8"

    @property
    def exec_mode(self) -> str:
        """What runs for this World's tensors, the label the loop stamps
        on its ``step`` spans: ``psum``; ``ring`` / ``ring_q8`` (the CUDA
        kernels) or ``ring_plain`` / ``ring_q8_plain`` (their plain
        versions, on the CPU)."""
        if self.mode == "psum":
            return "psum"
        on_kernel = self.world.device.type == "cuda"
        return self.mode if on_kernel else f"{self.mode}_plain"

    def wire_scale(self, dtype=torch.float32) -> float:
        """Bytes on the wire per logical payload byte (int8: 1/4 of f32)."""
        if not self.quantized:
            return 1.0
        return 1.0 / torch.empty((), dtype=dtype).element_size()

    def bucket_rows(self, shard_rows: int) -> list[tuple[int, int]]:
        """Row ranges ``[(r0, r1), ...]`` of the ``[shard_rows, 128]``
        shard view, one ring launch each: multiples of 32 rows, the tail
        keeps the remainder."""
        per = int(self.bucket_mb * 2**20) // (4 * LANE)  # f32 rows
        per = max(_BUCKET_ALIGN_ROWS, per - per % _BUCKET_ALIGN_ROWS)
        return [(r, min(r + per, shard_rows)) for r in range(0, shard_rows, per)]

    def _charge(self, name: str, p: int, rows: int, wire) -> None:
        plan = rc.plan_ring(p * rows * LANE, p, wire)
        rc.record_wire(name, plan, wire, scales=self.quantized,
                       mode=rc.executed_mode("sum", self.world.device))

    def scatter_grads(self, flat):
        """Sum-reduce-scatter ``[p, N]`` local gradients: ``[p, S]``, rank
        ``r``'s row its contiguous shard of the cross-rank sum (the
        ZeRO-1 scatter; the caller divides by ``p`` for the mean)."""
        p, n = flat.shape
        padded = padded_len(n, p)
        if padded != n:
            flat = torch.nn.functional.pad(flat, (0, padded - n))
        rows_s = padded // (p * LANE)
        if self.mode == "psum":
            return C.reduce_scatter(flat.view(p, p * rows_s, LANE)).reshape(p, -1)
        x4 = flat.view(p, p, rows_s, LANE)
        out = torch.empty((p, rows_s, LANE), dtype=torch.float32 if self.quantized else flat.dtype,
                          device=flat.device)
        wire = torch.int8 if self.quantized else flat.dtype
        for r0, r1 in self.bucket_rows(rows_s):
            self._charge("ring_reduce_scatter", p, r1 - r0, wire)
            rc.reduce_scatter_chunks(x4[:, :, r0:r1], quantized=self.quantized,
                                     out=out[:, r0:r1])
        return out.view(p, -1).to(flat.dtype)

    def param_shard(self, flat):
        """Each rank's contiguous shard of its flat params, ``[p, S]``."""
        return shard_of(flat)

    def gather_updates(self, u_shard, size: int):
        """All-gather ``[p, S]`` per-shard updates: ``[p, size]``, every
        rank's row the same full flat vector (the ZeRO-1 gather)."""
        p, s = u_shard.shape
        rows_s = s // LANE
        if self.mode == "psum":
            return C.allgather(u_shard.view(p, rows_s, LANE)).reshape(p, -1)[:, :size]
        u3 = u_shard.reshape(p, rows_s, LANE)
        full = torch.empty((p, p, rows_s, LANE), dtype=u_shard.dtype, device=u_shard.device)
        wire = torch.int8 if self.quantized else u_shard.dtype
        for r0, r1 in self.bucket_rows(rows_s):
            self._charge("ring_all_gather", p, r1 - r0, wire)
            rc.all_gather_chunks(u3[:, r0:r1], quantized=self.quantized,
                                 out=full[:, :, r0:r1])
        return full.view(p, -1)[:, :size]

    def allreduce_grads(self, flat, *, mean: bool = True):
        """Mean-allreduce ``[p, N]`` flat gradients, the plain-DP sync:
        ``pmean`` in psum mode, else the bucketed ring reduce-scatter and
        all-gather of the sum divided by ``p``. ``mean`` False: the sum
        (in psum mode the rank-order sum on every rank)."""
        p, n = flat.shape
        if self.mode == "psum":
            return C.pmean(flat) if mean else C.rank_sum(flat).expand_as(flat)
        summed = self.scatter_grads(flat)
        return self.gather_updates(summed / p if mean else summed, n)
