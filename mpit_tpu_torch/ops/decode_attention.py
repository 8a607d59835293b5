"""Flash-decode: length-aware attention against the KV cache, dense or paged.

The serving engine's attention on the cache path. Queries ``[B, T, H,
Dh]`` (the T newest positions of each slot, global position ``lengths +
t``) attend to the slot's cached keys; key ``j`` is visible to query
``t`` iff ``j <= lengths + t``. A slot holding ``L`` tokens needs only
the first ``ceil((L + T) / block_k)`` tiles of its cache, so on the card
both wrappers launch the hand-written kernel in
``csrc/decode_attention.cu``, which never reads past that bound:

- :func:`flash_decode_attention` — padded per-slot ``[B, S, H, Dh]``
  K/V buffers;
- :func:`flash_paged_decode_attention` — a ``[P, page_size, H, Dh]``
  page pool, each slot's pages named by its block-table row.

K/V may be f32, bf16, or :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`
(int8 rows and per-(row, head) f32 scales, which the kernel dequantizes
as it reads the rows it visits); q is f32 or bf16, independently of
K/V. The kernel has four bodies, picked by :func:`_decode_path` from
the dtypes and the query width alone: ``split`` for T = 1 (the decode
tick: the block's warps share the slot's keys and merge at the end),
``mma`` for bf16 q and K/V at T > 1 (the bf16 prefills, on the tensor
cores), ``q8mma`` for bf16 q over int8 K/V at T > 1 (the int8-K/V
prefills, on the tensor cores: the int8 rows are exact in bf16, and p
times the V scale enters the PV product as three bf16 pieces, so it
keeps f32 precision as the JAX kernel's f32 p does) and ``rows`` for
the rest (an f32 operand at T > 1). :func:`reference_decode_attention` and
:func:`reference_paged_decode_attention` are the plain versions (the
einsum attention with an f32 softmax over the whole gathered,
dequantized cache); the wrappers take them only for tensors that lie on
the CPU. A CUDA tensor goes to the kernel or raises — there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from mpit_tpu_torch.ops.build import load
from mpit_tpu_torch.ops.kv_quant import QuantizedKV

__all__ = [
    "flash_decode_attention",
    "flash_paged_decode_attention",
    "launches",
    "path_launches",
    "num_kv_blocks",
    "pick_block_k",
    "reference_decode_attention",
    "reference_paged_decode_attention",
]

_KERNEL_SOURCE = "decode_attention.cu"
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# Shared memory a Hopper block may use (with the opt-in the kernel sets
# for a long block-table row), and the geometry each body stages with (as
# in csrc/decode_attention.cu and csrc/attn_mma.cuh).
_MAX_SMEM = 232448
_KC, _ROWS = 32, 4  # rows body: keys a chunk, query rows a block
_SPLIT_WARPS = 4  # split body: warps sharing a slot's chunks
_SPLIT_DOUBLE_MAX = 192 * 1024  # split body: double-buffered below this
_MMA_TILE = 64  # mma and q8mma bodies: query rows and keys of a tile

_PATHS = {
    "flash_decode_attention": ("split", "mma", "rows"),
    "flash_decode_attention_int8": ("split", "q8mma", "rows"),
    "flash_paged_decode_attention": ("split", "mma", "rows"),
    "flash_paged_decode_attention_int8": ("split", "q8mma", "rows"),
}
_C_PATHS = ("rows", "mma", "split", "q8mma")  # mpit_decode_path's answers, in order
# Launches of each form of the CUDA kernel since the counts were last set
# to 0, and of each "<form>/<body>"; a wrapper adds one to both where it
# launches, and nowhere else, under the lock: the fleet's worker threads
# launch concurrently.
launches = dict.fromkeys(_PATHS, 0)
path_launches = {f"{form}/{path}": 0 for form, paths in _PATHS.items() for path in paths}
_COUNT_LOCK = threading.Lock()


def reference_decode_attention(q, k, v, lengths):
    """Dense cached attention, ``[B, T, H, Dh]`` vs padded ``[B, S, H,
    Dh]``: the kernel's plain version IS the serving reference,
    :func:`mpit_tpu_torch.models.gpt2.cached_attention` (one
    implementation; imported here lazily, since ops sits below models)."""
    from mpit_tpu_torch.models.gpt2 import cached_attention

    return cached_attention(q, k, v, lengths)


def reference_paged_decode_attention(q, k_pool, v_pool, lengths, block_table):
    """Paged attention through the gathered dense view:
    :func:`mpit_tpu_torch.models.gpt2.paged_cached_attention`."""
    from mpit_tpu_torch.models.gpt2 import paged_cached_attention

    return paged_cached_attention(q, k_pool, v_pool, lengths, block_table)


def pick_block_k(s: int, want: int | None = None) -> int:
    """The cache-length tile: an explicit ``want`` is clamped to S;
    ``None`` picks the largest power of two <= 256 dividing S that gives
    at least 4 tiles (floor 8), else S itself (one tile)."""
    if want is not None:
        return min(want, s)
    b = 256
    while b > 8 and (s % b or s // b < 4):
        b //= 2
    return b if s % b == 0 else s


def num_kv_blocks(lengths, t_q: int, s: int, block_k: int):
    """Tiles a slot's loop visits: ``ceil((L + T) / block_k)`` clamped to
    ``[1, S / block_k]``. Works on numpy arrays and torch tensors."""
    n = (lengths + t_q + block_k - 1) // block_k
    return n.clip(1, s // block_k)


def _decode_path(q_dtype, kv_dtype, t: int) -> str:
    """The body a kernel call runs (``kv_dtype`` is the payload's:
    ``torch.int8`` for QuantizedKV): ``"split"`` at T = 1, ``"mma"`` for
    bf16 q and K/V at T > 1, ``"q8mma"`` for bf16 q over int8 K/V at
    T > 1, else ``"rows"``. The C entry points apply the same rule
    (``path_of`` in ``csrc/decode_attention.cu``); the wrapper counts a
    launch by the C answer and refuses a call where the two part. An f32
    operand keeps T > 1 on ``rows``: f32 products need f32 FMAs."""
    if t == 1:
        return "split"
    if q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16:
        return "mma"
    if q_dtype == torch.bfloat16 and kv_dtype == torch.int8:
        return "q8mma"
    return "rows"


def _smem_bytes(path: str, d: int, pages_per_slot: int, kv_dtype) -> int:
    """Shared memory, static and dynamic, that a block of ``path`` takes
    at head dim ``d`` with a block-table row of ``pages_per_slot`` pages
    (0 for the dense form) and K/V payload dtype ``kv_dtype``: what each
    body of ``csrc/decode_attention.cu`` allocates, as its
    ``mpit_decode_smem_bytes`` reads it from the compiled kernels."""
    table = 4 * pages_per_slot
    if path == "rows":
        return 4 * (_ROWS * d + _KC * (d + 1) + _KC * d) + table
    if path == "mma":  # the Q tile and two stages of K and V, [64][d + 8] bf16
        return 5 * _MMA_TILE * (d + 8) * 2 + table
    if path == "q8mma":  # Q, K and V tiles as bf16; two stages of int8 K, V rows and scales
        return 3 * _MMA_TILE * (d + 8) * 2 + 2 * (2 * _MMA_TILE * d + 2 * _MMA_TILE * 4) + table
    if path == "split":
        stage = 2 * _KC * (d * kv_dtype.itemsize + 16) + (2 * _KC * 4 if kv_dtype == torch.int8 else 0)
        stages = 2 if _SPLIT_WARPS * 2 * stage <= _SPLIT_DOUBLE_MAX else 1
        static = 4 * (d + _SPLIT_WARPS * d + 2 * _SPLIT_WARPS)
        return static + _SPLIT_WARPS * stages * stage + table
    raise ValueError(f"unknown decode path {path!r}")


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The flash-decode kernel's library, built from its source at the
    first call (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpit_flash_decode.argtypes = (
        [ptr] * 8 + [i32] * 6 + [f32, i32, i32, ptr]
    )
    lib.mpit_flash_paged_decode.argtypes = (
        [ptr] * 9 + [i32] * 7 + [f32, i32, i32, ptr]
    )
    lib.mpit_flash_decode.restype = i32
    lib.mpit_flash_paged_decode.restype = i32
    lib.mpit_decode_path.argtypes = [i32] * 3
    lib.mpit_decode_path.restype = i32
    lib.mpit_decode_smem_bytes.argtypes = [i32] * 5
    lib.mpit_decode_smem_bytes.restype = i32
    lib.mpit_cuda_error_string.argtypes = [i32]
    lib.mpit_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kv_parts(k, v):
    """``(k payload, v payload, k scales, v scales)`` — scales ``None``
    for plain buffers — or ValueError for a mixed pair."""
    if isinstance(k, QuantizedKV) != isinstance(v, QuantizedKV):
        raise ValueError("k and v must share one dtype (both QuantizedKV or neither)")
    if isinstance(k, QuantizedKV):
        return k.q, v.q, k.scale, v.scale
    return k, v, None, None


def _check_kernel_inputs(q, k, v, lengths, block_table=None):
    """Raise ValueError for anything the kernel does not take. Dense:
    k, v ``[B, S, H, Dh]``; paged (``block_table`` ``[B,
    pages_per_slot]`` int32): k, v ``[P, page_size, H, Dh]``."""
    kq, vq, ks, vs = _kv_parts(k, v)
    named = [("q", q), ("k", kq), ("v", vq), ("lengths", lengths)]
    if ks is not None:
        named += [("k scale", ks), ("v scale", vs)]
    if block_table is not None:
        named.append(("block_table", block_table))
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {q.dtype}")
    if kq.dtype != vq.dtype:
        raise ValueError(f"k and v must share one dtype, got {kq.dtype}, {vq.dtype}")
    if kq.dtype not in _KV_DTYPES or (kq.dtype == torch.int8) != (ks is not None):
        raise ValueError(
            f"K/V must be float32, bfloat16 or QuantizedKV (int8), got {kq.dtype}"
        )
    for name, x in (("lengths", lengths), ("block_table", block_table)):
        if x is not None and x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if q.dim() != 4 or kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(
            f"expected q [B, T, H, Dh] and k = v of rank 4, got "
            f"{tuple(q.shape)}, {tuple(kq.shape)}, {tuple(vq.shape)}"
        )
    b, t, h, d = q.shape
    rows_ok = block_table is not None or kq.shape[0] == b
    bt_ok = block_table is None or (
        block_table.dim() == 2 and block_table.shape[0] == b
    )
    if not rows_ok or not bt_ok or kq.shape[2:] != (h, d) or lengths.shape != (b,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(kq.shape)}, "
            f"lengths {tuple(lengths.shape)}"
            + ("" if block_table is None else f", block_table {tuple(block_table.shape)}")
        )
    if ks is not None:
        want = tuple(kq.shape[:-1]) + (1,)
        if ks.dtype != torch.float32 or tuple(ks.shape) != want or vs.shape != ks.shape:
            raise ValueError(f"int8 K/V scales must be float32 {want}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_KERNEL_HEAD_DIMS}")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary")
    if b < 1 or t < 1:
        raise ValueError(f"empty batch or query: B={b}, T={t}")
    if block_table is not None:
        path = _decode_path(q.dtype, kq.dtype, t)
        smem = _smem_bytes(path, d, block_table.shape[1], kq.dtype)
        if smem > _MAX_SMEM:
            raise ValueError(
                f"a block-table row of {block_table.shape[1]} pages needs "
                f"{smem} bytes of shared memory on the {path} body (> {_MAX_SMEM})"
            )


def _launch(q, k, v, lengths, block_table, s_len: int, bk: int):
    """Launch the kernel on the current stream: ``s_len`` is S (dense) or
    the page size (paged). Returns ``(out, visited)``."""
    _check_kernel_inputs(q, k, v, lengths, block_table)
    kq, vq, ks, vs = _kv_parts(k, v)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    visited = torch.empty((b,), dtype=torch.int32, device=q.device)
    lib = kernel_library()
    scales = (None, None) if ks is None else (ks.data_ptr(), vs.data_ptr())
    codes = (_Q_DTYPES[q.dtype], _KV_DTYPES[kq.dtype])
    path = _C_PATHS[lib.mpit_decode_path(*codes, t)]
    if path != _decode_path(q.dtype, kq.dtype, t):
        raise RuntimeError(
            f"the kernel would run the {path} body where _decode_path says "
            f"{_decode_path(q.dtype, kq.dtype, t)}"
        )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (q.data_ptr(), kq.data_ptr(), vq.data_ptr(), *scales)
        tail = (lengths.data_ptr(), out.data_ptr(), visited.data_ptr(), b, t, s_len)
        if block_table is None:
            err = lib.mpit_flash_decode(
                *head, *tail, h, d, bk, 1.0 / math.sqrt(d), *codes, stream
            )
        else:
            err = lib.mpit_flash_paged_decode(
                *head, block_table.data_ptr(), *tail, block_table.shape[1],
                h, d, bk, 1.0 / math.sqrt(d), *codes, stream,
            )
    if err:
        msg = (
            lib.mpit_cuda_error_string(err).decode()
            if err > 0
            else "unsupported dtype or head dim"
        )
        raise RuntimeError(f"flash-decode kernel launch failed ({err}): {msg}")
    form = "flash_decode_attention" if block_table is None else "flash_paged_decode_attention"
    form += "" if ks is None else "_int8"
    with _COUNT_LOCK:
        launches[form] += 1
        path_launches[f"{form}/{path}"] += 1
    return out, visited


def flash_decode_attention(
    q, k, v, lengths, *, block_k: int | None = None, return_visited=False
):
    """Length-aware cached attention: ``[B, T, H, Dh]`` queries against
    padded ``[B, S, H, Dh]`` K/V buffers (plain or
    :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`), ``lengths``
    ``[B]`` int32.

    ``block_k`` tiles the cache length (default :func:`pick_block_k`) and
    must divide S. ``return_visited`` also returns the per-slot visited
    tile count ``[B]`` int32 — written by the kernel itself on the card,
    the :func:`num_kv_blocks` formula on the CPU.

    CUDA tensors launch the kernel (counted in :data:`launches`); CPU
    tensors run :func:`reference_decode_attention`.
    """
    s = k.shape[1]
    bk = pick_block_k(s, block_k)
    if s % bk:
        raise ValueError(f"cache length {s} must be divisible by block_k={bk}")
    if q.device.type == "cpu":
        out = reference_decode_attention(q, k, v, lengths)
        visited = num_kv_blocks(lengths.int(), q.shape[1], s, bk)
    elif q.device.type == "cuda":
        out, visited = _launch(q, k, v, lengths, None, s, bk)
    else:
        raise ValueError(f"no flash-decode kernel for device {q.device}")
    return (out, visited) if return_visited else out


def flash_paged_decode_attention(
    q, k_pool, v_pool, lengths, block_table, *, block_k: int | None = None,
    return_visited=False,
):
    """Length-aware attention against a paged pool: ``[B, T, H, Dh]``
    queries vs ``[P, page_size, H, Dh]`` pools (plain or
    :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV`), each slot's
    pages named by ``block_table`` ``[B, pages_per_slot]`` int32, whose
    entries must name pages of the pool.

    The tile loop and its bound are :func:`flash_decode_attention`'s over
    the slot's virtual ``pages_per_slot · page_size`` cache. ``block_k``
    defaults to :func:`pick_block_k` of the page size and must divide it,
    as in the JAX package (the kernel resolves the page per key row, so
    nothing in it needs that). CUDA tensors launch the kernel; CPU
    tensors run :func:`reference_paged_decode_attention`.
    """
    ps = k_pool.shape[1]
    bk = pick_block_k(ps, block_k)
    if ps % bk:
        raise ValueError(f"page_size {ps} must be divisible by block_k={bk}")
    if q.device.type == "cpu":
        out = reference_paged_decode_attention(
            q, k_pool, v_pool, lengths, block_table
        )
        s_virtual = block_table.shape[1] * ps
        visited = num_kv_blocks(lengths.int(), q.shape[1], s_virtual, bk)
    elif q.device.type == "cuda":
        out, visited = _launch(q, k_pool, v_pool, lengths, block_table, ps, bk)
    else:
        raise ValueError(f"no flash-decode kernel for device {q.device}")
    return (out, visited) if return_visited else out
