"""Ring reduce-scatter and all-gather, sum and int8 wire, over the ranks
of one World: the port of :mod:`mpit_tpu.ops.ring_collectives`.

Rank-stacked tensors. The JAX package runs one program per device under
``shard_map``; the port drives every rank from one process, so a
collective takes the ranks' tensors stacked along a leading rank
dimension: a reduce-scatter ``[p, p, rows, 128]`` (rank, chunk, row,
lane) → ``[p, rows, 128]``, an all-gather ``[p, rows, 128]`` →
``[p, p, rows, 128]``. Rows and lanes must be dense; the rank and chunk
dimensions may be strided, so the gradient-sync bucket loop hands the
kernel row ranges of its flat buffers in place.

- :func:`plan_ring` / :func:`plan_shards` / :class:`RingPlan` — the
  host-side planner, geometry for geometry the JAX package's: the
  payload is lane-padded and split into ``p`` contiguous chunks, each
  tile-padded at its tail, so chunk ``i`` is always elements
  ``[i·c, (i+1)·c)`` of the padded payload (``opt.sharded.shard_of``'s
  layout). The tile pad is a TPU layout need; the CUDA kernels take any
  row count, and zero rows change neither a sum nor an amax, so the
  gradient-sync buckets skip it (the plan still prices the wire).
- :func:`quantize_chunk` / :func:`dequantize_chunk` — one scale per
  chunk, the shared int8 contract below.
- :func:`reduce_scatter_plain` / :func:`all_gather_plain` — the plain
  versions: the kernels' ring order, hop by hop, on rank-stacked
  tensors. The CPU runs them; on the card they are the kernels' yardstick.
- :func:`reduce_scatter_chunks` / :func:`all_gather_chunks` — the
  wrappers: a CPU tensor takes the plain version, a CUDA tensor the
  kernel of ``csrc/ring_collectives.cu`` or an error, never a fallback.
  Every rank of a World lies on one card, so nothing has to travel and
  each runs as one pass over HBM: the sum reduce-scatter as the fold
  (each rank's copies of a chunk added in the ring's order, with its
  roundings, so bit-equal to the plain version), the sum all-gather as
  a copy (each shard read once and written into every rank's output).
  The q8 forms keep the int8 value in registers and share each chunk's
  amax across blocks at a barrier: the q8 reduce-scatter as the q8 fold
  (each chunk's hop chain computed in place, a barrier a hop), the q8
  all-gather as the q8 copy (each shard read, its amax met at one
  barrier, the dequantized chunk written into every rank's output).
  Each has two forms: ``resident`` where what a block keeps (the fold's
  f32 partials, the copy's shard rows) fits in shared memory, one pass
  over HBM; else ``stream`` (the fold one pass a hop, the copy two). The
  C library's plan (:func:`q8_plan`) names the form and
  :data:`path_launches` counts launches by it.
- :func:`ring_reduce_scatter` / :func:`ring_all_gather` — the public
  collectives on rank-stacked payloads, through the planner; ``p = 1``
  is a no-op (nothing crosses a wire, nothing is quantized).

The int8 rounding contract, shared with :mod:`mpit_tpu.ops.ring_collectives`:
one scale per block, ``amax / 127`` in f32 (1.0 for an all-zero block,
so dequantizing it is exact), ``round(x / scale)`` half to even
(``torch.round`` rounds half to even, as ``jnp.round`` does), clipped
to ±127. The expressions are evaluated in the JAX package's order, so
the int8 payloads and scales are bit-identical to its. The divisions
take a tensor divisor: PyTorch's CUDA ``div`` by a Python scalar
multiplies by its reciprocal, which is not ``amax / 127`` rounded once.
A NaN in a chunk propagates through the plain amax; the kernel's
``fmaxf`` drops it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mpit_tpu_torch import obs
from mpit_tpu_torch.ops.build import load

__all__ = [
    "MAX_RANKS",
    "RingPlan",
    "SCALE_ROWS",
    "all_gather_chunks",
    "all_gather_plain",
    "dequantize_blocks",
    "dequantize_chunk",
    "device_error",
    "executed_mode",
    "launches",
    "path_launches",
    "plan_ring",
    "plan_shards",
    "q8_plan",
    "quantize_blocks",
    "quantize_chunk",
    "record_wire",
    "reduce_scatter_chunks",
    "reduce_scatter_plain",
    "ring_all_gather",
    "ring_reduce_scatter",
    "sublane_for",
]

_LANE = 128
# Minimal second-minor tile rows by dtype itemsize on the TPU (f32 (8,
# 128), bf16 (16, 128), int8 (32, 128)): the planner's geometry.
_SUBLANE_BY_ITEMSIZE = {4: 8, 2: 16, 1: 32}
# Rows of the f32 block that carries one per-chunk scale on the TPU's
# wire; the kernels here ship one f32 per block, the plan prices JAX's.
SCALE_ROWS = 8
SCALE_BLOCK_BYTES = SCALE_ROWS * _LANE * 4
MAX_RANKS = 16  # the kernels' pointer table
_KERNEL_SOURCE = "ring_collectives.cu"
# The C library's kinds: ring_rs is the fold, ring_rs_q8 the q8 fold,
# ring_ag the copy, ring_ag_q8 the q8 copy.
_KINDS = {"ring_rs": 0, "ring_rs_q8": 1, "ring_ag": 2, "ring_ag_q8": 3}
# The q8 kinds' forms, in the order of mpit_q8_plan's answer; the other
# kinds take no workspace.
_Q8_FORMS = {"ring_rs_q8": ("q8fold_resident", "q8fold_stream"),
             "ring_ag_q8": ("q8copy_resident", "q8copy_stream")}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WS_WORDS = 2 * 256  # one rank's workspace in the kernels (64-bit words)

# Launches of each CUDA kernel since the counts were last set to 0, and
# the q8 kinds' launches by the form the C library's plan names; a
# wrapper adds one where it launches, and nowhere else.
launches = dict.fromkeys(_KINDS, 0)
path_launches = dict.fromkeys([f for forms in _Q8_FORMS.values() for f in forms], 0)


def sublane_for(dtype) -> int:
    """Tile rows required for ``dtype`` in the [rows, 128] lane view."""
    return _SUBLANE_BY_ITEMSIZE[torch.empty((), dtype=dtype).element_size()]


def _pad_last(x, total: int):
    pad = total - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Geometry of one ring collective over ``p`` ranks.

    ``chunk_rows`` is the logical per-rank chunk in [rows, 128] lane
    rows; ``padded_rows`` rounds it up to the wire dtype's tile sublane.
    The pad lives at each chunk's tail, so rank ``i``'s chunk is always
    the contiguous elements ``[i·chunk_elems, (i+1)·chunk_elems)`` of the
    lane-padded payload. The host-side methods take any leading (rank)
    dimensions."""

    p: int
    chunk_rows: int
    padded_rows: int

    @property
    def chunk_elems(self) -> int:
        return self.chunk_rows * _LANE

    @property
    def wire_rows(self) -> int:
        """Total [rows, 128] rows crossing the planner (all chunks)."""
        return self.p * self.padded_rows

    def wire_payload_bytes(self, wire_dtype, *, scales: bool = False) -> float:
        """The bytes-on-the-wire payload the ``(P-1)/P·N`` ring formulas
        are fed; ``scales=True`` adds one scale block per chunk (q8)."""
        item = torch.empty((), dtype=wire_dtype).element_size()
        per_chunk = self.padded_rows * _LANE * item
        if scales:
            per_chunk += SCALE_BLOCK_BYTES
        return float(self.p * per_chunk)

    def to_wire(self, flat):
        """``[..., n]`` payload → ``[..., p·padded_rows, 128]``: zero-pad
        to ``p·chunk_elems``, then pad each chunk's tail."""
        lead = flat.shape[:-1]
        x = _pad_last(flat, self.p * self.chunk_elems)
        x = x.reshape(*lead, self.p, self.chunk_rows, _LANE)
        if self.padded_rows != self.chunk_rows:
            x = torch.nn.functional.pad(x, (0, 0, 0, self.padded_rows - self.chunk_rows))
        return x.reshape(*lead, self.p * self.padded_rows, _LANE)

    def shard_to_wire(self, shard):
        """``[..., chunk_elems or fewer]`` → ``[..., padded_rows, 128]``."""
        lead = shard.shape[:-1]
        x = _pad_last(shard, self.chunk_elems).reshape(*lead, self.chunk_rows, _LANE)
        if self.padded_rows != self.chunk_rows:
            x = torch.nn.functional.pad(x, (0, 0, 0, self.padded_rows - self.chunk_rows))
        return x

    def shard_from_wire(self, shard2d):
        """``[..., padded_rows, 128]`` → ``[..., chunk_elems]`` (strips the
        tile pad; the payload's lane pad stays, as the layout contract
        says)."""
        x = shard2d[..., : self.chunk_rows, :]
        return x.reshape(*x.shape[:-2], self.chunk_elems)

    def full_from_wire(self, full2d):
        """``[..., p·padded_rows, 128]`` → ``[..., p·chunk_elems]``."""
        lead = full2d.shape[:-2]
        x = full2d.reshape(*lead, self.p, self.padded_rows, _LANE)
        return x[..., : self.chunk_rows, :].reshape(*lead, self.p * self.chunk_elems)

    def gathered_from_wire(self, full2d, shard_elems: int):
        """``[..., p·padded_rows, 128]`` → ``[..., p·shard_elems]``:
        strips both pads of every chunk."""
        lead = full2d.shape[:-2]
        x = full2d.reshape(*lead, self.p, self.padded_rows * _LANE)
        return x[..., :shard_elems].reshape(*lead, self.p * shard_elems)


def plan_ring(payload_elems: int, p: int, wire_dtype) -> RingPlan:
    """Plan a ring moving ``payload_elems`` elements per rank over ``p``
    ranks with ``wire_dtype`` on the wire (``p = 1``: a valid plan, no
    wire)."""
    if payload_elems <= 0:
        raise ValueError(f"payload_elems must be positive, got {payload_elems}")
    per = payload_elems + (-payload_elems) % (p * _LANE)
    rows = per // (p * _LANE)
    sub = sublane_for(wire_dtype)
    padded = max(rows + (-rows) % sub, sub)
    return RingPlan(p=p, chunk_rows=rows, padded_rows=padded)


def plan_shards(shard_elems: int, p: int, wire_dtype) -> RingPlan:
    """Plan an all-gather where every rank contributes ``shard_elems``."""
    if shard_elems <= 0:
        raise ValueError(f"shard_elems must be positive, got {shard_elems}")
    rows = -(-shard_elems // _LANE)
    sub = sublane_for(wire_dtype)
    padded = max(rows + (-rows) % sub, sub)
    return RingPlan(p=p, chunk_rows=rows, padded_rows=padded)


# ---------------------------------------------------------------------------
# Quantization: the one int8 contract.
# ---------------------------------------------------------------------------


def _q8_scale(amax):
    """The one scale rule: ``amax / 127`` in f32, 1.0 where amax is 0."""
    amax = amax.float()
    return torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)


def _q8_round(x, scale):
    """The one rounding rule: half to even, clipped to ±127, as int8."""
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)


def quantize_blocks(x, dim: int = -1):
    """One scale per slice along ``dim``: returns ``(q int8 like x,
    scale f32 with dim kept at size 1)``."""
    x = x.float()
    scale = _q8_scale(x.abs().amax(dim=dim, keepdim=True))
    return _q8_round(x, scale), scale


def dequantize_blocks(q, scale):
    """Inverse of :func:`quantize_blocks` (f32; ``scale`` broadcasts)."""
    return q.float() * scale


def quantize_chunk(x):
    """One scale over the whole chunk: ``(q int8, scale f32 0-d)``;
    round-trip error at most ``scale / 2`` an element."""
    x = x.float()
    scale = _q8_scale(x.abs().amax())
    return _q8_round(x, scale), scale


def dequantize_chunk(q, scale):
    """Inverse of :func:`quantize_chunk` (f32)."""
    return q.float() * scale


def _quantize_ranks(x):
    """:func:`quantize_chunk` of every rank's chunk of ``x [p, ...]``:
    ``(q int8 like x, scale f32 [p, 1, ...])``."""
    x = x.float()
    amax = x.abs().reshape(x.shape[0], -1).amax(dim=1)
    scale = _q8_scale(amax).reshape(-1, *([1] * (x.dim() - 1)))
    return _q8_round(x, scale), scale


# ---------------------------------------------------------------------------
# Plain versions: the ring order, hop by hop, on rank-stacked tensors.
# ---------------------------------------------------------------------------


def _check_stacked(xs, kind: str):
    want = 4 if kind == "rs" else 3
    if xs.dim() != want or xs.shape[-1] != _LANE:
        shape = "[p, p, rows, 128]" if kind == "rs" else "[p, rows, 128]"
        raise ValueError(f"expected a rank-stacked {shape} tensor, got {tuple(xs.shape)}")
    if kind == "rs" and xs.shape[0] != xs.shape[1]:
        raise ValueError(f"{xs.shape[0]} ranks but {xs.shape[1]} chunks a rank")


def reduce_scatter_plain(xs, *, quantized: bool = False):
    """The reduce-scatter kernels' plain version: ``xs [p, p, rows, 128]``
    → ``[p, rows, 128]``, rank ``i`` ending with chunk ``i`` summed over
    the ranks, in ``xs``' dtype (f32 with ``quantized``).

    Rank ``i`` sends chunk ``(i-1-s) mod p`` at step ``s = 0`` and its
    running partial after that; it folds the partial arriving from rank
    ``i-1`` into its chunk ``(i-2-s) mod p``. ``quantized``: each hop
    ships the f32 partial as int8 with one scale per chunk, and the
    receiver computes ``f32(q) · scale + f32(x)``, two roundings."""
    _check_stacked(xs, "rs")
    p = xs.shape[0]
    if p == 1:
        return xs[:, 0].float() if quantized else xs[:, 0].clone()
    ranks = torch.arange(p, device=xs.device)
    acc = None
    for s in range(p - 1):
        outgoing = xs[ranks, (ranks - 1 - s) % p] if s == 0 else acc
        mine = xs[ranks, (ranks - 2 - s) % p]
        if quantized:
            q, scale = _quantize_ranks(outgoing)
            incoming = dequantize_chunk(q.roll(1, 0), scale.roll(1, 0))
            acc = incoming + mine.float()
        else:
            acc = outgoing.roll(1, 0) + mine
    return acc


def all_gather_plain(xs, *, quantized: bool = False):
    """The all-gather kernels' plain version: ``xs [p, rows, 128]`` →
    ``[p, p, rows, 128]`` in ``xs``' dtype, every rank holding every
    rank's chunk in ring order. ``quantized``: each rank's chunk is
    quantized once, travels verbatim, and is dequantized by every rank,
    its owner included, so every replica holds the same bits."""
    _check_stacked(xs, "ag")
    p = xs.shape[0]
    out = xs.new_empty((p, p, *xs.shape[1:]))
    ranks = torch.arange(p, device=xs.device)
    if quantized:
        q, scale = _quantize_ranks(xs)
        out[ranks, ranks] = dequantize_chunk(q, scale).to(xs.dtype)
    else:
        payload = xs
        out[ranks, ranks] = xs
    for s in range(p - 1):
        recv = (ranks - 1 - s) % p
        if quantized:
            q, scale = q.roll(1, 0), scale.roll(1, 0)
            out[ranks, recv] = dequantize_chunk(q, scale).to(xs.dtype)
        else:
            payload = payload.roll(1, 0)
            out[ranks, recv] = payload
    return out


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The ring kernels' library, built from its source at the first call
    (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    i32, i64, u64p = ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint64)
    lib.mpit_ring_launch.argtypes = [i32, i32, i32, i32, u64p, u64p, u64p, i64, i64,
                                     ctypes.c_uint64, ctypes.c_void_p]
    lib.mpit_ring_launch.restype = i32
    lib.mpit_q8_plan.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.mpit_q8_plan.restype = i32
    lib.mpit_q8_quot_mismatches.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                                            ctypes.c_void_p, ctypes.c_void_p]
    lib.mpit_q8_quot_mismatches.restype = i32
    lib.mpit_ring_error.argtypes = []
    lib.mpit_ring_error.restype = i32
    lib.mpit_ring_error_string.argtypes = [i32]
    lib.mpit_ring_error_string.restype = ctypes.c_char_p
    return lib


class _Workspace:
    """One device's amax-barrier flags and partial amaxes for every rank
    (zeroed once, never cleared) and its call counter: every launch takes
    the next epoch, so its tokens exceed all earlier ones."""

    def __init__(self, device):
        self.flags = torch.zeros((MAX_RANKS, _WS_WORDS), dtype=torch.int64, device=device)
        self.epoch = 0


_WORKSPACES: dict = {}


def _workspace(device) -> _Workspace:
    ws = _WORKSPACES.get(device)
    if ws is None:
        ws = _WORKSPACES[device] = _Workspace(device)
    return ws


def device_error() -> str | None:
    """What the error word of a q8 kernel whose amax barrier timed out
    says (None if none has), readable after the trap has cost the CUDA
    context."""
    if not torch.cuda.is_available():
        return None
    word = kernel_library().mpit_ring_error()
    if not word:
        return None
    return (f"ring amax barrier timed out: rank {(word >> 8) & 0xFF}'s workspace, "
            f"block {(word >> 16) & 0xFF}, barrier {word >> 24}")


def _dense_rows(x, name: str):
    if x.stride(-1) != 1 or x.stride(-2) != _LANE:
        raise ValueError(f"{name} must have dense [rows, 128] chunks, strides {x.stride()}")
    if x.data_ptr() % 16 or any(st * x.element_size() % 16 for st in x.stride()[:-1]):
        raise ValueError(f"{name} must be 16-byte aligned with strides of whole 16-byte vectors")


def _ring_error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.mpit_ring_error_string(err).decode() if err > 0 else "arguments refused"
    return RuntimeError(f"{what} failed ({err}): {msg}")


@functools.lru_cache(maxsize=1024)
def q8_plan(kind: str, p: int, rows: int, dtype, device) -> dict:
    """The C library's plan (``mpit_q8_plan``) for q8 kind ``kind``
    (``ring_rs_q8``, the q8 fold; ``ring_ag_q8``, the q8 copy) over ``p``
    ranks' ``[rows, 128]`` chunks of ``dtype`` on CUDA ``device``: the
    form (``*_resident``: the fold's partials or the copy's shard rows
    stay in shared memory; ``*_stream``: the fold's partials live in the
    output, one pass a hop, and the copy reads its rows twice), the
    blocks a chunk and the shared memory a block."""
    lib = kernel_library()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = lib.mpit_q8_plan(_KINDS[kind], _DTYPES[dtype], p, rows, out)
    if err:
        raise _ring_error(lib, err, f"{kind} plan")
    return {"form": _Q8_FORMS[kind][out[0]], "blocks": out[1], "smem_bytes": out[2]}


def _launch(kind: str, xs, out, in_cs: int, out_cs: int):
    """Launch ``kind`` over the ranks of ``xs``. The q8 kinds take the
    workspace (their amax barrier) and count their launches by form; the
    fold and the copy take nothing else."""
    p, rows = xs.shape[0], xs.shape[-2]
    if not 2 <= p <= MAX_RANKS:
        raise ValueError(f"the ring kernels take 2 to {MAX_RANKS} ranks, got {p}")
    if xs.dtype not in _DTYPES:
        raise ValueError(f"ring kernel dtype must be float32 or bfloat16, got {xs.dtype}")
    if out.device != xs.device:
        raise ValueError(f"out is on {out.device}, the input on {xs.device}")
    lib = kernel_library()

    def table(t):  # rank r's address, without making p views (host time)
        step = t.stride(0) * t.element_size()
        return (ctypes.c_uint64 * p)(*(t.data_ptr() + r * step for r in range(p)))

    flags = None
    epoch = 0
    if kind in _Q8_FORMS:
        ws = _workspace(xs.device)
        flags = table(ws.flags)
        ws.epoch += 1
        epoch = ws.epoch
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.mpit_ring_launch(
            _KINDS[kind], _DTYPES[xs.dtype], p, rows, table(xs), table(out), flags,
            in_cs, out_cs, epoch, stream,
        )
    if err:
        raise _ring_error(lib, err, f"{kind} kernel launch")
    launches[kind] += 1
    if kind in _Q8_FORMS:
        path_launches[q8_plan(kind, p, rows, xs.dtype, xs.device)["form"]] += 1


def _device_kind(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ring kernel for device {x.device}")
    return x.device.type


def _rs_out(xs, quantized: bool, out):
    _check_stacked(xs, "rs")
    p, rows = xs.shape[0], xs.shape[2]
    dtype = torch.float32 if quantized else xs.dtype
    if out is None:
        return torch.empty((p, rows, _LANE), dtype=dtype, device=xs.device)
    if tuple(out.shape) != (p, rows, _LANE) or out.dtype != dtype:
        raise ValueError(f"out must be {dtype} {(p, rows, _LANE)}, got {out.dtype} {tuple(out.shape)}")
    return out


def reduce_scatter_chunks(xs, *, quantized: bool = False, out=None):
    """Reduce-scatter rank-stacked chunks ``xs [p, p, rows, 128]`` into
    ``out [p, rows, 128]`` (new if None; xs' dtype, f32 if
    ``quantized``): the kernel for CUDA tensors (the sum as the one-pass
    fold, the q8 form as the q8 fold), the plain version for CPU ones."""
    out = _rs_out(xs, quantized, out)
    if _device_kind(xs) == "cpu" or xs.shape[0] == 1:
        out.copy_(reduce_scatter_plain(xs, quantized=quantized))
        return out
    _dense_rows(xs, "xs")
    _dense_rows(out, "out")
    _launch("ring_rs_q8" if quantized else "ring_rs", xs, out, xs.stride(1), 0)
    return out


def all_gather_chunks(xs, *, quantized: bool = False, out=None):
    """All-gather rank-stacked chunks ``xs [p, rows, 128]`` into ``out [p,
    p, rows, 128]`` (new if None, xs' dtype): the kernel for CUDA
    tensors (the sum as the copy, the q8 form as the q8 copy), the plain
    version for CPU ones."""
    _check_stacked(xs, "ag")
    p, rows = xs.shape[0], xs.shape[1]
    if out is None:
        out = torch.empty((p, p, rows, _LANE), dtype=xs.dtype, device=xs.device)
    elif tuple(out.shape) != (p, p, rows, _LANE) or out.dtype != xs.dtype:
        raise ValueError(f"out must be {xs.dtype} {(p, p, rows, _LANE)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if _device_kind(xs) == "cpu" or p == 1:
        out.copy_(all_gather_plain(xs, quantized=quantized))
        return out
    _dense_rows(xs, "xs")
    _dense_rows(out, "out")
    _launch("ring_ag_q8" if quantized else "ring_ag", xs, out, 0, out.stride(1))
    return out


# ---------------------------------------------------------------------------
# Public collectives.
# ---------------------------------------------------------------------------


def executed_mode(op: str, device) -> str:
    """What a ring collective runs for tensors on ``device``: ``ring``
    (the CUDA kernel) or ``ring_plain`` (the plain version, on the CPU),
    the label traces and spans carry."""
    if op not in ("sum", "qsum", "qcat"):
        raise ValueError(f"op must be 'sum', 'qsum' or 'qcat', got {op!r}")
    return "ring" if torch.device(device).type == "cuda" else "ring_plain"


def record_wire(name: str, plan: RingPlan, wire_dtype, *, scales: bool, mode: str) -> None:
    """Charge one collective's wire bytes (the plan's, at the quantized
    size) to the obs counter ``ring_wire_bytes`` when obs is on: what the
    JAX package charges, the ring's size on links between devices. With
    every rank on one card no wire bytes move (every form is one pass over
    HBM, or two); the counter still prices the ring."""
    obs.counter("ring_wire_bytes", plan.wire_payload_bytes(wire_dtype, scales=scales),
                collective=name, mode=mode)


def ring_reduce_scatter(xs, *, op: str = "sum"):
    """Ring reduce-scatter of rank-stacked payloads ``xs [p, ...]``.

    Each rank's payload is raveled and zero-padded to a ``p·128``
    multiple; rank ``i`` receives the reduced contiguous elements
    ``[i·c, (i+1)·c)`` as row ``i`` of the ``[p, c]`` result. ``op="sum"``
    reduces in the payload's dtype; ``op="qsum"`` ships int8 chunks with
    per-chunk scales and accumulates in f32 (lossy by design)."""
    if op not in ("sum", "qsum"):
        raise ValueError(f"op must be 'sum' or 'qsum', got {op!r}")
    quantized = op == "qsum"
    p = xs.shape[0]
    flat = xs.reshape(p, -1)
    out_dtype = torch.float32 if quantized else xs.dtype
    if p == 1:
        return flat.to(out_dtype)
    wire = torch.int8 if quantized else xs.dtype
    plan = plan_ring(flat.shape[1], p, wire)
    record_wire("ring_reduce_scatter", plan, wire, scales=quantized,
                mode=executed_mode(op, xs.device))
    x4 = plan.to_wire(flat).reshape(p, p, plan.padded_rows, _LANE)
    return plan.shard_from_wire(reduce_scatter_chunks(x4, quantized=quantized))


def ring_all_gather(shards, *, quantized: bool = False, out_size: int | None = None):
    """Ring all-gather of rank-stacked shards ``shards [p, ...]``: every
    rank receives the concatenation in ring order (rank ``i``'s shard at
    ``[i·c, (i+1)·c)``), row ``r`` of the ``[p, p·c]`` result being rank
    ``r``'s copy, identical on every rank. ``quantized`` ships each
    shard as int8 with one scale; ``out_size`` trims the trailing pad."""
    p = shards.shape[0]
    flat = shards.reshape(p, -1)
    if p == 1:
        return flat if out_size is None else flat[:, :out_size]
    wire = torch.int8 if quantized else shards.dtype
    plan = plan_shards(flat.shape[1], p, wire)
    record_wire("ring_all_gather", plan, wire, scales=quantized,
                mode=executed_mode("qcat" if quantized else "sum", shards.device))
    full = all_gather_chunks(plan.shard_to_wire(flat), quantized=quantized)
    out = plan.gathered_from_wire(full.reshape(p, p * plan.padded_rows, _LANE), flat.shape[1])
    return out if out_size is None else out[:, :out_size]
