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
  The kernel has two bodies, one load-store loop in two shapes:
  ``wave`` (four words a thread, one wave up to full residency: the
  fleet's shipments) and ``stream`` (a word a thread: large buffers);
  the C library's plan (:func:`kernel_plan`, ``mpit_kv_ship_plan``) picks
  one by size, and :data:`path_launches` counts the launches by body.

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

__all__ = [
    "BODIES",
    "byte_view",
    "kernel_plan",
    "launches",
    "path_launches",
    "ship_bytes",
    "ship_bytes_plain",
    "tensor_nbytes",
]

_KERNEL_SOURCE = "kv_ship.cu"
BODIES = ("wave", "stream")  # mpit_kv_ship_plan's bodies, in order

# Launches of the CUDA kernel since the count was last set to 0, and the
# same launches by body; the wrapper adds one where it launches, and
# nowhere else.
launches = {"kv_ship": 0}
path_launches = dict.fromkeys(BODIES, 0)
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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mpit_kv_ship_plan.argtypes = [ptr, ptr, i64, i32, i32, ctypes.POINTER(i32)]
    lib.mpit_kv_ship_plan.restype = i32
    lib.mpit_kv_ship.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.mpit_kv_ship.restype = i32
    lib.mpit_kv_ship_error_string.argtypes = [i32]
    lib.mpit_kv_ship_error_string.restype = ctypes.c_char_p
    return lib


def _error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.mpit_kv_ship_error_string(err).decode() if err > 0 else "arguments refused"
    return RuntimeError(f"kv_ship {what} failed ({err}): {msg}")


@functools.lru_cache(maxsize=4096)
def _plan(n: int, src_mod: int, dst_mod: int, body: int, device: int) -> tuple:
    # The plan reads the addresses modulo 16 alone, so two 16-byte-aligned
    # stand-ins carry them.
    lib = kernel_library()
    out = (ctypes.c_int * 3)()
    err = lib.mpit_kv_ship_plan(16 + src_mod, 64 + dst_mod, n, body, device, out)
    if err:
        raise _error(lib, err, "plan")
    return BODIES[out[0]], out[1], out[2]


def kernel_plan(src: torch.Tensor, dst: torch.Tensor, body: str | None = None) -> dict:
    """The C library's plan for copying ``src`` into ``dst`` (CUDA
    tensors): the body (``wave`` or ``stream``; ``body`` asks for one),
    the word it moves (16 bytes where both addresses agree modulo 16) and
    the grid's blocks."""
    n = _check(src, dst)
    code = _body_code(body)
    got, word, blocks = _plan(n, src.data_ptr() % 16, dst.data_ptr() % 16, code,
                              src.device.index)
    return {"body": got, "word": word, "blocks": blocks}


def _body_code(body) -> int:
    """The C library's code for ``body`` (-1: the plan's choice)."""
    if body is None:
        return -1
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES} or None, got {body!r}")
    return BODIES.index(body)


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


def ship_bytes(src: torch.Tensor, dst: torch.Tensor, *, body: str | None = None) -> torch.Tensor:
    """Copy ``src``'s bytes into ``dst``, bit for bit: the kernel for CUDA
    tensors (on the current stream, the body the plan picks; ``body``
    asks for one, as the tests and the chip smoke do), the plain version
    for CPU ones. Returns ``dst``."""
    n = _check(src, dst)
    code = _body_code(body)
    if src.device.type == "cpu":
        return ship_bytes_plain(src, dst)
    if n == 0:
        return dst  # nothing to move
    index = src.device.index
    s, d = src.data_ptr(), dst.data_ptr()
    ran = _plan(n, s % 16, d % 16, code, index)[0]
    lib = kernel_library()
    err = lib.mpit_kv_ship(s, d, n, code, index, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise _error(lib, err, "kernel launch")
    with _COUNT_LOCK:
        launches["kv_ship"] += 1
        path_launches[ran] += 1
    return dst
