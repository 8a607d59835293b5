"""The port's kernel build names each library by what goes into it.

``mpit_tpu_torch.ops.build._lib_path`` hashes a source together with every
shared header in ``csrc/`` and the compiler flags: an edited header must
give a new library path (so it is rebuilt), and nothing changed must give
the same path (so it is reused). No ``nvcc`` is needed: nothing is built.
"""

from __future__ import annotations

from mpit_tpu_torch.ops import build


def test_lib_path_follows_the_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "kern.cu").write_text('#include "tile.cuh"\nint f() { return g(); }\n')
    (tmp_path / "tile.cuh").write_text("inline int g() { return 1; }\n")
    first = build._lib_path("kern.cu")
    assert first.parent == tmp_path / "out" and first.name.startswith("libkern_")
    assert build._lib_path("kern.cu") == first  # nothing changed: reused
    (tmp_path / "tile.cuh").write_text("inline int g() { return 2; }\n")
    edited = build._lib_path("kern.cu")
    assert edited != first  # the header changed: rebuilt
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert build._lib_path("kern.cu") != edited
    (tmp_path / "kern.cu").write_text('#include "tile.cuh"\nint f() { return -g(); }\n')
    assert build._lib_path("kern.cu") not in (first, edited)


def test_headers_are_not_libraries():
    assert all(src.endswith(".cu") for src in build.KERNEL_SOURCES)
    assert (build.CSRC / "attn_mma.cuh").exists()
    assert "attn_mma.cuh" not in build.KERNEL_SOURCES
