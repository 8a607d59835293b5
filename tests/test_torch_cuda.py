"""mpit_tpu_torch's CUDA kernel on the GPU, against its plain version.

Every test here needs an NVIDIA GPU (the kernel has no CPU mode): each
carries the ``cuda`` marker and skips, with its reason, where there is
none. This file imports only torch and the port, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 within 1e-4 (different summation order, TF32 off);
bf16 within 5e-2, the JAX package's own bf16 kernel tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.ops import decode_attention as tda
from mpit_tpu_torch.serve import Engine, Request, Server

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("h,d", [(12, 64), (3, 16), (2, 128)])
def test_kernel_matches_plain(cuda, dtype, tol, t, h, d):
    s = 256
    rng = np.random.default_rng(t * d)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to("cuda", dtype)
        for shape in ((4, t, h, d), (4, s, h, d), (4, s, h, d))
    )
    lens = torch.tensor([0, 5, 100, s - t], dtype=torch.int32, device="cuda")
    before = tda.flash_decode_attention.launches
    out, vis = tda.flash_decode_attention(q, k, v, lens, return_visited=True)
    torch.cuda.synchronize()
    assert tda.flash_decode_attention.launches == before + 1
    ref = tda.reference_decode_attention(q, k, v, lens)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    bk = tda.pick_block_k(s)
    assert torch.equal(vis.cpu(), tda.num_kv_blocks(lens.cpu(), t, s, bk))


def test_kernel_engine_matches_reference_engine(cuda):
    """A staggered greedy stream through two slots: the kernel engine's
    tokens equal the reference engine's in f32."""
    cfg = GPT2Config.tiny(
        vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
        dtype=torch.float32,
    )
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    prompts = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
    tokens = {}
    for mode in ("kernel", "reference"):
        server = Server(
            Engine(cfg, state, slots=2, max_len=40, prefill_len=8,
                   decode_attention=mode)
        )
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        tokens[mode] = {c.rid: c.tokens for c in server.run()}
    assert tokens["kernel"] == tokens["reference"]
