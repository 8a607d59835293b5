"""The int8 weight store and the fused-dequant matmul that serves it.

A matmul weight is stored as int8 plus one f32 scale per row
(:class:`QuantizedTensor`), through the one rounding contract of
:mod:`mpit_tpu_torch.ops.ring_collectives` (``amax / 127``, half to
even, ±127), so the port stores the very bytes :mod:`mpit_tpu` stores.
For a projection kernel ``[D, F]`` the grain is one scale per
contraction row; for the embedding / LM head ``[V, D]`` one per
vocabulary row.

Three matmul forms, one arithmetic — a weight dequantizes as the single
f32 product ``f32(q) * scale``, and every sum is f32:

- :func:`quantized_matmul` — ``x @ W`` for ``W`` ``[D, F]``, the serving
  matmul. A CUDA tensor launches the hand-written kernel in
  ``csrc/quantized_matmul.cu`` at every shape (it masks every tail; a
  full dequantized weight never exists): bf16 x on the tensor cores
  (the ``mma`` body: each dequantized weight as three exact bf16
  pieces), f32 x on f32 FMAs (``fma``), the contraction split across
  blocks where the output tiles alone would not fill the card; the C
  library's plan (``mpit_qmm_plan``) names the body, the tile and the
  split. A CPU tensor runs :func:`quantized_matmul_plain`, its plain
  version. Nothing else.
- :func:`quantized_matmul_t` — ``x @ W.T`` for ``W`` ``[V, D]``, the
  in-model LM head, blocked over the output rows.
- :func:`quantized_matmul_reference` — whole-tensor dequant, then one
  matmul: the reference engine's oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from mpit_tpu_torch.ops.build import load
from mpit_tpu_torch.ops.ring_collectives import dequantize_blocks, quantize_blocks

__all__ = [
    "DEFAULT_BLOCK_ROWS",
    "SCALE_BYTES",
    "QuantizedTensor",
    "dequantize_tensor",
    "kernel_plan",
    "launches",
    "path_launches",
    "quantize_tensor",
    "quantized_matmul",
    "quantized_matmul_plain",
    "quantized_matmul_reference",
    "quantized_matmul_t",
    "weight_wire_bytes",
]

# f32 scale per weight row: the store's fixed overhead.
SCALE_BYTES = 4
# The plain version's contraction row-block (the JAX package's default).
DEFAULT_BLOCK_ROWS = 256

_KERNEL_SOURCE = "quantized_matmul.cu"
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C_PATHS = ("fma", "mma")  # mpit_qmm_plan's bodies, in order
_WANT_PATH = {torch.float32: "fma", torch.bfloat16: "mma"}
# Zeroed 32-bit tile counters of the split contraction, one buffer per
# device: a split runs only where the output tiles are fewer than about
# two an SM, so this many cover any card.
_COUNTER_WORDS = 4096

# Launches of the CUDA kernel since the count was last set to 0, and the
# same launches by the body the C library's plan names; the wrapper adds
# one where it launches, and nowhere else.
launches = {"quantized_matmul": 0}
path_launches = dict.fromkeys(_C_PATHS, 0)
# Guards the creation of a device's scratch (and so of its lock), and the
# counts above, which every device's launches share.
_COUNT_LOCK = threading.Lock()


@dataclasses.dataclass
class QuantizedTensor:
    """One quantized weight: ``q`` int8 ``[..., rows, cols]`` and
    ``scale`` f32 ``[..., rows, 1]`` (keepdims, so both share rank).
    ``shape``/``dtype``/``ndim`` are the int8 payload's; indexing picks
    rows of both together (the embedding gather)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def ndim(self):
        return self.q.ndim

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(q=self.q[idx], scale=self.scale[idx])


def quantize_tensor(x) -> QuantizedTensor:
    """Quantize a weight ``[..., rows, cols]``, one scale per row (an
    all-zero row gets scale 1.0 and round-trips to exact zeros)."""
    q, scale = quantize_blocks(x, dim=-1)
    return QuantizedTensor(q=q, scale=scale)


def dequantize_tensor(t: QuantizedTensor) -> torch.Tensor:
    """The whole f32 view: the oracle's, and the gathered rows' of the
    embedding. The serving matmul never forms it."""
    return dequantize_blocks(t.q, t.scale)


def weight_wire_bytes(shape, dtype) -> float:
    """Device bytes one weight occupies: ``"int8"`` / ``torch.int8`` is
    the int8 payload plus one f32 scale per leading row; any other
    dtype is the dense tensor in that dtype."""
    n = 1
    for s in shape:
        n *= int(s)
    if dtype in ("int8", torch.int8):
        rows = n // int(shape[-1]) if len(shape) else 1
        return float(n + rows * SCALE_BYTES)
    return float(n * dtype.itemsize)


def _block(rows: int, block_rows) -> int:
    """The row-block: ``block_rows`` (default 256), at most ``rows``
    rounded up to 8, as in the JAX package."""
    return min(block_rows or DEFAULT_BLOCK_ROWS, rows + (-rows) % 8)


def quantized_matmul_plain(x, w: QuantizedTensor, *, block_rows=None):
    """Blocked ``x @ W`` over the contraction dim, the kernel's plain
    version (the JAX package's ``quantized_matmul_lax``): per block of
    ``block_rows`` rows one ``[block, F]`` tile is dequantized and
    contracted, and the partial products are summed in f32. Rows past D
    are zero int8 with scale 1.0 against zero columns of x. Returns f32
    ``[..., F]``."""
    d, f = w.q.shape
    block = _block(d, block_rows)
    pad = (-d) % block
    q, scale, x32 = w.q, w.scale, x.float()
    if pad:
        q = torch.cat([q, q.new_zeros((pad, f))])
        scale = torch.cat([scale, scale.new_ones((pad, 1))])
        x32 = torch.cat([x32, x32.new_zeros((*x32.shape[:-1], pad))], dim=-1)
    acc = x32.new_zeros((*x.shape[:-1], f))
    for i in range(0, d + pad, block):
        w_i = dequantize_blocks(q[i : i + block], scale[i : i + block])
        acc = acc + x32[..., i : i + block] @ w_i
    return acc


def quantized_matmul_t(x, w: QuantizedTensor, *, block_rows=None):
    """Blocked ``x @ W.T`` for ``W`` ``[V, D]`` (the LM head against a
    quantized head or embedding), one ``[block, D]`` f32 tile at a
    time. Blocks split the output columns only, so each logit sees the
    whole contraction. Returns f32 ``[..., V]``."""
    v = w.q.shape[0]
    block = _block(v, block_rows)
    x32 = x.float()
    parts = [
        x32 @ dequantize_tensor(w[i : i + block]).T for i in range(0, v, block)
    ]
    return torch.cat(parts, dim=-1)


def quantized_matmul_reference(x, w: QuantizedTensor, *, block_rows=None):
    """Whole-dequant oracle: the full f32 weight, then one matmul. What
    reference engines run. Returns f32 ``[..., F]``."""
    del block_rows
    return x.float() @ dequantize_tensor(w)


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The matmul kernel's library, built from its source at the first
    call (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpit_qmm_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.mpit_qmm_plan.restype = i32
    lib.mpit_quantized_matmul.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.mpit_quantized_matmul.restype = i32
    lib.mpit_qmm_error_string.argtypes = [i32]
    lib.mpit_qmm_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(x2, w: QuantizedTensor) -> None:
    """Raise ValueError for anything the kernel does not take: x ``[M,
    D]`` f32 or bf16, ``q`` ``[D, F]`` int8, ``scale`` ``[D, 1]`` f32,
    all contiguous on one device."""
    for name, t in (("x", x2), ("q", w.q), ("scale", w.scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise ValueError(
            f"weight must be int8 with float32 scales, got {w.q.dtype}, "
            f"{w.scale.dtype}"
        )
    if w.q.dim() != 2 or tuple(w.scale.shape) != (w.q.shape[0], 1):
        raise ValueError(
            f"expected q [D, F] and scale [D, 1], got {tuple(w.q.shape)}, "
            f"{tuple(w.scale.shape)}"
        )
    m, d = x2.shape
    if d != w.q.shape[0]:
        raise ValueError(f"x has {d} features, the weight {w.q.shape[0]} rows")
    if m < 1 or w.q.shape[1] < 1:
        raise ValueError(f"empty matmul: M={m}, F={w.q.shape[1]}")


def _error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.mpit_qmm_error_string(err).decode() if err > 0 else "arguments refused"
    return RuntimeError(f"quantized-matmul {what} failed ({err}): {msg}")


@functools.lru_cache(maxsize=1024)
def kernel_plan(m: int, d: int, f: int, dtype, device) -> dict:
    """The C library's plan for x ``[m, d]`` of ``dtype`` against an int8
    ``[d, f]`` weight on CUDA ``device`` (``mpit_qmm_plan``): the body
    (``mma`` or ``fma``), the tile's rows and columns, the split ``S`` of
    the contraction and the grid's blocks."""
    lib = kernel_library()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.mpit_qmm_plan(m, d, f, _X_DTYPES[dtype], out)
    if err:
        raise _error(lib, err, "plan")
    return {"path": _C_PATHS[out[0]], "tile": (out[1], out[2]), "splits": out[3],
            "blocks": out[4]}


class _SplitScratch:
    """One device's scratch for the split contraction: the tile counters
    (zeroed once; the last block of a tile sets its counter back to 0)
    and the f32 workspace of the slices' partial sums (``torch.empty``,
    grown when a call needs more). Kept rather than allocated a call, to
    keep the wrapper's host time short beside the decode tick's short
    launches.

    Calls on one device share both, so they must run in one stream's
    order, as the port's do: every thread of the port (the fleet's
    workers among them) launches on the device's default stream. The
    host side is guarded by ``lock``: a launch holds it from its plan
    through ``take`` to the queued launch and its count, so no other
    thread can grow the workspace (and free the block a queued launch
    was handed) between one thread's ``take`` and its launch."""

    def __init__(self, device):
        self.lock = threading.Lock()
        self.counters = torch.zeros(_COUNTER_WORDS, dtype=torch.int32, device=device)
        self.workspace = torch.empty(0, dtype=torch.float32, device=device)

    def take(self, elems: int) -> torch.Tensor:
        if self.workspace.numel() < elems:
            self.workspace = torch.empty(elems, dtype=torch.float32,
                                         device=self.counters.device)
        return self.workspace


_SCRATCH: dict = {}


def _scratch(device) -> _SplitScratch:
    s = _SCRATCH.get(device)
    if s is None:
        with _COUNT_LOCK:
            s = _SCRATCH.get(device)
            if s is None:
                s = _SCRATCH[device] = _SplitScratch(device)
    return s


def _launch(x2, w: QuantizedTensor) -> torch.Tensor:
    """Launch the kernel on the current stream: f32 ``[M, F]``. Plan,
    workspace, launch and count form one critical section under the
    device's lock (:class:`_SplitScratch`)."""
    _check_kernel_inputs(x2, w)
    m, d = x2.shape
    f = w.q.shape[1]
    out = torch.empty((m, f), dtype=torch.float32, device=x2.device)
    lib = kernel_library()
    scratch = _scratch(x2.device)
    with scratch.lock:
        p = kernel_plan(m, d, f, x2.dtype, x2.device)
        if p["path"] != _WANT_PATH[x2.dtype]:
            raise RuntimeError(
                f"the C library plans the {p['path']} body for {x2.dtype} x, "
                f"not {_WANT_PATH[x2.dtype]}"
            )
        # A workspace [S, M, F] and the tile counters; ``ws`` holds the
        # tensor itself until the launch is queued.
        ws = scratch.take(p["splits"] * m * f) if p["splits"] > 1 else None
        with torch.cuda.device(x2.device):
            stream = torch._C._cuda_getCurrentRawStream(x2.device.index)
            err = lib.mpit_quantized_matmul(
                x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if ws is None else scratch.counters.data_ptr(),
                _COUNTER_WORDS, m, d, f, _X_DTYPES[x2.dtype], stream,
            )
        if err:
            raise _error(lib, err, "kernel launch")
        with _COUNT_LOCK:
            launches["quantized_matmul"] += 1
            path_launches[p["path"]] += 1
    return out


def quantized_matmul(x, w: QuantizedTensor, *, block_rows=None):
    """``x @ W`` against an int8-per-row weight ``[D, F]``: x ``[...,
    D]`` f32 or bf16, returns f32 ``[..., F]``.

    A CUDA tensor launches the kernel at every shape (counted in
    :data:`launches` and, by the body the C library's plan names, in
    :data:`path_launches`; ``block_rows`` is the plain version's and does
    not change the kernel); a CPU tensor runs
    :func:`quantized_matmul_plain`. Any other device raises."""
    f = w.q.shape[1]
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w, block_rows=block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"no quantized-matmul kernel for device {x.device}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _launch(x2, w).reshape(*x.shape[:-1], f)
