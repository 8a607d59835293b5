"""Build the port's CUDA kernels from ``mpit_tpu_torch/csrc`` at first use.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with :mod:`ctypes` — no PyTorch
headers, so a build takes seconds. Libraries land in ``build/torch_ext/``
at the root of the checkout (listed in ``.gitignore``) under a name that
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. Nothing here runs at import:
this module is imported on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "KERNEL_SOURCES", "build", "event_count", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
# Every kernel source of the port; chip_smoke.py builds them all at once.
KERNEL_SOURCES = (
    "decode_attention.cu", "quantized_matmul.cu", "flash_attention.cu", "ring_collectives.cu",
    "kv_ship.cu",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


# Sources compiled and libraries loaded in this process: what a
# CompileWatch (obs/roofline.py) reads around a call.
_events = 0


def event_count() -> int:
    """How many sources this process has compiled and libraries it has
    loaded so far."""
    return _events


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def _lib_path(source: str) -> Path:
    """Where ``source``'s library lives: named by a hash of the source,
    of every header in ``CSRC`` (sorted by name; a source may include
    any of them) and of the flags, so an edit to any of them rebuilds."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build(sources=KERNEL_SOURCES, *, force: bool = False) -> dict[str, str]:
    """Compile every source in ``sources`` that has no up-to-date library
    yet (every one with ``force``), one ``nvcc`` per source, all started
    together. Returns ``{source: compiler output}`` for the sources
    compiled by this call (``ptxas`` register and shared-memory usage
    included); raises with the compiler's output if any build fails."""
    global _events
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for source in sources:
        out = _lib_path(source)
        if out.exists() and not force:
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        running[source] = (proc, tmp, out)
        _events += 1
    logs = {}
    failed = []
    for source, (proc, tmp, out) in running.items():
        log = proc.communicate()[0].decode(errors="replace")
        logs[source] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {source}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    global _events
    build((source,))
    _events += 1
    return ctypes.CDLL(str(_lib_path(source)))
