"""mpit_tpu_torch's CUDA kernels on the GPU, against their plain versions.

The flash-decode kernel in all four forms (dense and paged, each with
f32/bf16 or int8 K/V), and the int8 weight store's fused-dequant matmul.

Every test here needs an NVIDIA GPU (the kernel has no CPU mode): each
carries the ``cuda`` marker and skips, with its reason, where there is
none. This file imports only torch and the port, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 within 1e-4 (different summation order, TF32 off);
bf16 within 5e-2, the JAX package's own bf16 kernel tolerance. int8 K/V
take q's tolerance: both sides dequantize the same bytes to f32; with a
bf16 q the kernel keeps p in f32 (V is f32 once dequantized, as on the
TPU) where the plain version rounds the probabilities to bf16, a
difference well inside 5e-2. The matmul is held within 1e-4 x max(1,
max |plain|) for f32 and bf16 x alike: bf16 -> f32 is exact, both sides
dequantize to the same f32 weights and sum in f32, in other orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.ops import decode_attention as tda
from mpit_tpu_torch.ops import quantized_matmul as tqm
from mpit_tpu_torch.ops.kv_quant import quantize_kv
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
    before = tda.launches["flash_decode_attention"]
    out, vis = tda.flash_decode_attention(q, k, v, lens, return_visited=True)
    torch.cuda.synchronize()
    assert tda.launches["flash_decode_attention"] == before + 1
    ref = tda.reference_decode_attention(q, k, v, lens)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    bk = tda.pick_block_k(s)
    assert torch.equal(vis.cpu(), tda.num_kv_blocks(lens.cpu(), t, s, bk))


def _randn(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to("cuda", dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("ps,t", [(4, 1), (16, 7), (64, 1), (16, 33)])
def test_paged_kernel_matches_plain(cuda, dtype, tol, int8, ps, t):
    """Pages in a scrambled order, two slots sharing their first pages;
    ragged lengths up to the virtual capacity."""
    b, h, d, s = 4, 3, 64, 256
    n_ps = s // ps
    p = b * n_ps + 3
    q = _randn((b, t, h, d), t, dtype)
    k, v = (_randn((p, ps, h, d), seed, dtype) for seed in (1, 2))
    if int8:
        k, v = quantize_kv(k), quantize_kv(v)
    bt = torch.randperm(p, generator=torch.Generator().manual_seed(ps))[: b * n_ps]
    bt = bt.reshape(b, n_ps).int()
    bt[1, :2] = bt[0, :2]
    bt = bt.cuda()
    lens = torch.tensor([0, 5, 100, s - t], dtype=torch.int32, device="cuda")
    form = "flash_paged_decode_attention" + ("_int8" if int8 else "")
    before = tda.launches[form]
    out, vis = tda.flash_paged_decode_attention(
        q, k, v, lens, bt, return_visited=True
    )
    torch.cuda.synchronize()
    assert tda.launches[form] == before + 1
    ref = tda.reference_paged_decode_attention(q, k, v, lens, bt)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    bk = tda.pick_block_k(ps)
    assert torch.equal(vis.cpu(), tda.num_kv_blocks(lens.cpu(), t, s, bk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_int8_kernel_matches_plain(cuda, dtype):
    b, t, h, d, s = 4, 5, 12, 64, 256
    q = _randn((b, t, h, d), 0, dtype)
    k, v = (quantize_kv(_randn((b, s, h, d), seed, dtype)) for seed in (1, 2))
    lens = torch.tensor([0, 5, 100, s - t], dtype=torch.int32, device="cuda")
    before = tda.launches["flash_decode_attention_int8"]
    out = tda.flash_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tda.launches["flash_decode_attention_int8"] == before + 1
    ref = tda.reference_decode_attention(q, k, v, lens)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_identity_paged_equals_dense_bitwise(cuda, int8):
    """The paged kernel over a pool whose block table maps slot b's
    pages in order onto its own dense rows reads the very values the
    dense kernel reads, in the same order: equal bit for bit."""
    b, t, h, d, s, ps = 4, 3, 12, 64, 256, 16
    q = _randn((b, t, h, d), 0, torch.bfloat16)
    k, v = (_randn((b, s, h, d), seed, torch.bfloat16) for seed in (1, 2))
    if int8:
        k, v = quantize_kv(k), quantize_kv(v)
    pool = lambda x: x.reshape(b * (s // ps), ps, *x.shape[2:])
    kp = type(k)(pool(k.q), pool(k.scale)) if int8 else pool(k)
    vp = type(v)(pool(v.q), pool(v.scale)) if int8 else pool(v)
    bt = torch.arange(b * (s // ps), dtype=torch.int32, device="cuda").reshape(b, -1)
    lens = torch.tensor([0, 9, 100, s - t], dtype=torch.int32, device="cuda")
    bk = tda.pick_block_k(ps)
    dense = tda.flash_decode_attention(q, k, v, lens, block_k=bk)
    paged = tda.flash_paged_decode_attention(q, kp, vp, lens, bt, block_k=bk)
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_kernel_engine_matches_reference_engine(cuda, kv_dtype):
    """Shared prefixes through the paged kernel engine: greedy tokens
    equal the dense reference engine's (f32, same kv_dtype)."""
    cfg = GPT2Config.tiny(
        vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
        dtype=torch.float32,
    )
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    sysp = [11, 12, 13, 14, 15]
    prompts = [sysp + [20, 21], sysp + [30], sysp + [20, 21], sysp + [30, 31, 32]]
    tokens = {}
    for paged in (True, False):
        geo = dict(kv_pages=24, kv_page_size=4) if paged else {}
        engine = Engine(
            cfg, state, slots=2, max_len=40, prefill_len=16, kv_dtype=kv_dtype,
            decode_attention="kernel" if paged else "reference", **geo,
        )
        server = Server(engine)
        # The second request stays live while the later ones arrive.
        for i, (p, n) in enumerate(zip(prompts, (3, 14, 6, 4))):
            server.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        tokens[paged] = {c.rid: c.tokens for c in server.run()}
        if paged:
            assert engine.allocator.prefix_hits >= 1
    assert tokens[True] == tokens[False]


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


@pytest.mark.parametrize(
    "m,d,f,dtype",
    [
        (8, 768, 2304, torch.float32),
        (8, 768, 2304, torch.bfloat16),
        (5, 100, 130, torch.float32),  # every tail ragged, bytewise loads
    ],
)
def test_quantized_matmul_kernel_matches_plain(cuda, m, d, f, dtype):
    x = _randn((m, d), 0, dtype)
    w = tqm.quantize_tensor(_randn((d, f), 1, torch.float32))
    before = tqm.launches["quantized_matmul"]
    out = tqm.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert tqm.launches["quantized_matmul"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (m, f)
    ref = tqm.quantized_matmul_plain(x, w)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


def test_int8_weight_kernel_engine_matches_reference_engine(cuda):
    """Greedy tokens of the int8-weight kernel engine (matmul and
    attention kernels) equal the whole-dequant reference engine's in
    f32; the matmul kernel ran for every dense layer of every call."""
    cfg = GPT2Config.tiny(
        vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
        dtype=torch.float32,
    )
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    prompts = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
    tokens = {}
    for mode in ("kernel", "reference"):
        before = tqm.launches["quantized_matmul"]
        server = Server(
            Engine(cfg, state, slots=2, max_len=40, prefill_len=8,
                   decode_attention=mode, weights_dtype="int8")
        )
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        tokens[mode] = {c.rid: c.tokens for c in server.run()}
        launched = tqm.launches["quantized_matmul"] - before
        if mode == "kernel":  # every tick runs at least one forward
            assert launched >= 4 * cfg.num_layers * server.tick
        else:
            assert launched == 0
    assert tokens["kernel"] == tokens["reference"]
