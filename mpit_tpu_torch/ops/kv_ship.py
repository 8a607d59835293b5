"""Whole-buffer byte copy: the port of the KV shipment's remote-copy
kernel (:func:`mpit_tpu.serve.shipment.ship_kv_remote`, ``_ship_kernel``).

- :func:`ship_bytes_plain` — the plain version: ``dst.copy_(src)`` on
  same-dtype byte views. The CPU runs it; on the card it is the
  kernel's yardstick.
- :func:`ship_bytes` — the wrapper: CPU tensors take the plain version,
  CUDA tensors the kernel of ``csrc/kv_ship.cu`` or an error, never a
  fallback. Both tensors are contiguous, hold the same number of bytes
  and lie on one device; their dtypes and shapes may differ (a packed
  uint8 payload lands in a uint8 buffer, a bf16 leaf in a bf16 one).

Every CUDA payload of the compat simulator (a buffered ``Send``'s
snapshot and the delivery into the receiver's buffer) and of
:func:`mpit_tpu_torch.serve.shipment.ship_kv_remote` moves through
:func:`ship_bytes`. The launch count is kept under a lock: the fleet's
worker threads launch concurrently.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from mpit_tpu_torch.ops.build import load

__all__ = ["byte_view", "launches", "ship_bytes", "ship_bytes_plain", "tensor_nbytes"]

_KERNEL_SOURCE = "kv_ship.cu"

# Launches of the CUDA kernel since the count was last set to 0; the
# wrapper adds one where it launches, and nowhere else.
launches = {"kv_ship": 0}
_COUNT_LOCK = threading.Lock()


def tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor as a 1-D uint8 view (no copy)."""
    if not t.is_contiguous():
        raise ValueError(f"a byte view needs a contiguous tensor, strides {t.stride()}")
    return t.reshape(-1).view(torch.uint8)


def ship_bytes_plain(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst``'s bytes := ``src``'s, through ``copy_`` on byte views."""
    byte_view(dst).copy_(byte_view(src))
    return dst


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The copy kernel's library, built from its source at the first call
    (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    lib.mpit_kv_ship.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.mpit_kv_ship.restype = ctypes.c_int
    lib.mpit_kv_ship_error_string.argtypes = [ctypes.c_int]
    lib.mpit_kv_ship_error_string.restype = ctypes.c_char_p
    return lib


def _check(src: torch.Tensor, dst: torch.Tensor) -> int:
    if src.device != dst.device:
        raise ValueError(
            f"ship_bytes copies within one device: src on {src.device}, dst on {dst.device}"
        )
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no copy kernel for device {src.device}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("ship_bytes needs contiguous byte ranges (src and dst)")
    n = tensor_nbytes(src)
    if tensor_nbytes(dst) != n:
        raise ValueError(f"dst holds {tensor_nbytes(dst)} bytes, src {n}")
    lo, hi = src.data_ptr(), dst.data_ptr()
    if n and lo < hi + n and hi < lo + n:
        raise ValueError("ship_bytes: src and dst overlap")
    return n


def ship_bytes(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Copy ``src``'s bytes into ``dst``, bit for bit: the kernel for CUDA
    tensors (on the current stream), the plain version for CPU ones.
    Returns ``dst``."""
    n = _check(src, dst)
    if src.device.type == "cpu":
        return ship_bytes_plain(src, dst)
    if n == 0:
        return dst  # nothing to move
    lib = kernel_library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.mpit_kv_ship(src.data_ptr(), dst.data_ptr(), n, stream)
    if err:
        msg = lib.mpit_kv_ship_error_string(err).decode() if err > 0 else "arguments refused"
        raise RuntimeError(f"kv_ship kernel launch failed ({err}): {msg}")
    with _COUNT_LOCK:
        launches["kv_ship"] += 1
    return dst
