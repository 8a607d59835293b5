"""Flash-decode: length-aware attention against the padded KV cache.

The serving engine's attention on the cache path. Queries ``[B, T, H,
Dh]`` (the T newest positions of each slot, global position ``lengths +
t``) attend to the padded ``[B, S, H, Dh]`` K/V buffers; key ``j`` is
visible to query ``t`` iff ``j <= lengths + t``. A slot holding ``L``
tokens needs only the first ``ceil((L + T) / block_k)`` tiles of its
buffer, so on the card :func:`flash_decode_attention` launches the
hand-written kernel in ``csrc/decode_attention.cu``, which never reads
the tiles past that bound.

:func:`reference_decode_attention` is the plain version of the same
function (the einsum attention with an f32 softmax over the whole padded
buffer); the wrapper takes it only for tensors that lie on the CPU. A
CUDA tensor goes to the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpit_tpu_torch.ops.build import load

__all__ = [
    "flash_decode_attention",
    "num_kv_blocks",
    "pick_block_k",
    "reference_decode_attention",
]

_KERNEL_SOURCE = "decode_attention.cu"
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def reference_decode_attention(q, k, v, lengths):
    """Dense cached attention, ``[B, T, H, Dh]`` vs padded ``[B, S, H,
    Dh]``: the kernel's plain version IS the serving reference,
    :func:`mpit_tpu_torch.models.gpt2.cached_attention` (one
    implementation; imported here lazily, since ops sits below models)."""
    from mpit_tpu_torch.models.gpt2 import cached_attention

    return cached_attention(q, k, v, lengths)


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


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The flash-decode kernel's library, built from its source at the
    first call (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    lib.mpit_flash_decode.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int
    ] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.mpit_flash_decode.restype = ctypes.c_int
    lib.mpit_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpit_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, lengths):
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B, T, H, Dh] and k = v [B, S, H, Dh], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or lengths.shape != (b,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"lengths {tuple(lengths.shape)}"
        )
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_KERNEL_HEAD_DIMS}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary")
    if b < 1 or t < 1:
        raise ValueError(f"empty batch or query: B={b}, T={t}")


def flash_decode_attention(
    q, k, v, lengths, *, block_k: int | None = None, return_visited=False
):
    """Length-aware cached attention: ``[B, T, H, Dh]`` queries against
    padded ``[B, S, H, Dh]`` K/V buffers, ``lengths`` ``[B]`` int32.

    ``block_k`` tiles the cache length (default :func:`pick_block_k`) and
    must divide S. ``return_visited`` also returns the per-slot visited
    tile count ``[B]`` int32 — written by the kernel itself on the card,
    the :func:`num_kv_blocks` formula on the CPU.

    CUDA tensors launch the kernel (``launches`` counts each launch);
    CPU tensors run :func:`reference_decode_attention`.
    """
    s = k.shape[1]
    bk = pick_block_k(s, block_k)
    if s % bk:
        raise ValueError(f"cache length {s} must be divisible by block_k={bk}")
    if q.device.type == "cpu":
        out = reference_decode_attention(q, k, v, lengths)
        if return_visited:
            return out, num_kv_blocks(lengths.int(), q.shape[1], s, bk)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no flash-decode kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, lengths)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    visited = torch.empty((b,), dtype=torch.int32, device=q.device)
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.mpit_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), visited.data_ptr(),
            b, t, s, h, d, bk, 1.0 / math.sqrt(d), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        msg = (
            lib.mpit_cuda_error_string(err).decode()
            if err > 0
            else "unsupported dtype or head dim"
        )
        raise RuntimeError(f"flash-decode kernel launch failed ({err}): {msg}")
    flash_decode_attention.launches += 1
    return (out, visited) if return_visited else out


# Launches of the CUDA kernel since the count was last set to 0.
flash_decode_attention.launches = 0
