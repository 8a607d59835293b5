"""mpit_tpu_torch's CUDA kernels on the GPU, against their plain versions.

The flash-decode kernel in all four forms (dense and paged, each with
f32/bf16 or int8 K/V) and on each of its four bodies (split, mma,
q8mma, rows, checked through ``path_launches``; the body rule and the
shared memory each body takes, against the kernel library), the int8
weight store's fused-dequant matmul (its ``mma`` and ``fma`` bodies, as
the C library's plan names them, at GPT-2 small's shapes and the plan's
edges; the plan fills the card and its split contraction gives the same
bits every call, also from several threads at once), the training flash attention's
forward, dq and dk/dv kernels (alone, the bf16 dq and dk/dv on the
tensor cores at every head dim, in autograd, and in three tiny training
steps against plain attention),
the ring reduce-scatter and all-gather kernels, sum and int8 wire
(bit-equal to their plain versions: the sum forms as the one-card fold
and copy, the q8 reduce-scatter as the q8 fold and the q8 all-gather as
the q8 copy, each in both its forms; and in tiny training steps over
four ranks against the plain collectives; and at the convnets' bucket
plans), and the KV shipment's copy kernel
(bit-exact at every alignment on both its bodies and at AlexNet's
244.4 MB flat message, behind the compat simulator's CUDA messages, a
tiny fleet's shipments, the parameter-server actors and the elastic
tier's anchor, its launches counted); the checkpoints of a state on
the card (an asynchronous save ahead of an in-place step, a restore
into a bound four-rank state, bit for bit); and speculative decoding's
shapes (the decode kernel at the verify's T 2 to 5 on each body, the
matmul at its 40 rows, also from four threads) and its engine (f32
greedy tokens of the speculative kernel engine against the plain and
the speculative reference engines); and the observability layers on
the card (the engine's modeled visited tiles against the decode
kernel's own count, the memory ledger against
``torch.cuda.memory_allocated``, the profile window's trace holding the
flash kernels' device events); and the pjit and context-parallel
training tiers over the flash kernels (the TP step on each rank's head
shard and the ring's chain of offset flash blocks against their plain
versions, the CP step against the CPU's).

Every test here needs an NVIDIA GPU (the kernel has no CPU mode): each
carries the ``cuda`` marker and skips, with its reason, where there is
none. This file imports only torch and the port, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 within 1e-4 (different summation order, TF32 off);
bf16 within 5e-2, the JAX package's own bf16 kernel tolerance. int8 K/V
take q's tolerance: both sides dequantize the same bytes to f32; with a
bf16 q the kernel keeps p in f32 (V is f32 once dequantized, as on the
TPU; on the q8mma body p times the V scale enters the PV product as
three bf16 pieces that sum to it within 2^-27) where the plain version
rounds the probabilities to bf16, a difference well inside 5e-2. The matmul is held within 1e-4 x max(1,
max |plain|) for f32 and bf16 x alike: bf16 -> f32 is exact, both sides
dequantize to the same f32 weights and sum in f32, in other orders.
"""

from __future__ import annotations

import threading

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


def _path_delta(before):
    return {k: n - before[k] for k, n in tda.path_launches.items() if n != before[k]}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [None, 16, 64], ids=["dense", "ps16", "ps64"])
@pytest.mark.parametrize("t", [1, 64, 65, 128])
def test_decode_bodies_match_plain(cuda, kv, ps, t):
    """Each body at the query widths around its tiles (T 1: split; bf16
    T 64, 65, 128: mma, with a ragged 64-row tile at 65; int8 T > 1:
    q8mma, likewise), dense and paged (pages scrambled), lengths 0, 5,
    100 and S - T; bf16 within 5e-2, visited exact, and the launch
    counted on the body that ran."""
    b, h, d, s = 4, 3, 64, 256
    q = _randn((b, t, h, d), t, torch.bfloat16)
    lens = torch.tensor([0, 5, 100, s - t], dtype=torch.int32, device="cuda")
    if ps is None:
        k, v = (_randn((b, s, h, d), seed, torch.bfloat16) for seed in (1, 2))
    else:
        p = b * (s // ps) + 3
        k, v = (_randn((p, ps, h, d), seed, torch.bfloat16) for seed in (1, 2))
        bt = torch.randperm(p, generator=torch.Generator().manual_seed(t))[: b * (s // ps)]
        bt = bt.reshape(b, s // ps).int().cuda()
    if kv == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    form = ("flash_decode_attention" if ps is None else "flash_paged_decode_attention")
    form += "_int8" if kv == "int8" else ""
    path = tda._decode_path(torch.bfloat16, torch.int8 if kv == "int8" else torch.bfloat16, t)
    assert path == ("split" if t == 1 else "q8mma" if kv == "int8" else "mma")
    before = dict(tda.path_launches)
    if ps is None:
        out, vis = tda.flash_decode_attention(q, k, v, lens, return_visited=True)
        ref = tda.reference_decode_attention(q, k, v, lens)
        want = tda.num_kv_blocks(lens.cpu(), t, s, tda.pick_block_k(s))
    else:
        out, vis = tda.flash_paged_decode_attention(q, k, v, lens, bt, return_visited=True)
        ref = tda.reference_paged_decode_attention(q, k, v, lens, bt)
        want = tda.num_kv_blocks(lens.cpu(), t, s, tda.pick_block_k(ps))
    torch.cuda.synchronize()
    assert _path_delta(before) == {f"{form}/{path}": 1}
    assert (out.float() - ref.float()).abs().max().item() <= 5e-2
    assert torch.equal(vis.cpu(), want)


@pytest.mark.parametrize("t", [1, 3, 64, 65], ids=["split", "mma3", "mma64", "mma65"])
@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_identity_paged_equals_dense_bitwise(cuda, int8, t):
    """The paged kernel over a pool whose block table maps slot b's
    pages in order onto its own dense rows reads the very values the
    dense kernel reads, in the same order: equal bit for bit, on the
    split body (T 1) and on the tensor-core bodies at T > 1 (mma for
    bf16 K/V, q8mma for int8)."""
    b, h, d, s, ps = 4, 12, 64, 256, 16
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
    before = dict(tda.path_launches)
    dense = tda.flash_decode_attention(q, k, v, lens, block_k=bk)
    paged = tda.flash_paged_decode_attention(q, kp, vp, lens, bt, block_k=bk)
    path = "split" if t == 1 else "q8mma" if int8 else "mma"
    suffix = "_int8" if int8 else ""
    assert _path_delta(before) == {
        f"flash_decode_attention{suffix}/{path}": 1,
        f"flash_paged_decode_attention{suffix}/{path}": 1,
    }
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("ps", [None, 16, 64], ids=["dense", "ps16", "ps64"])
@pytest.mark.parametrize("t", [2, 65, 128])
def test_q8mma_body_matches_plain(cuda, d, ps, t):
    """The int8 tensor-core body (bf16 q over int8 K/V) at every head
    dim, dense and paged (pages scrambled, two slots sharing pages),
    T 2, a ragged 65 and 128, slot lengths spread from 0 to S - T:
    within 5e-2 of the plain version, visited exact, one launch on
    q8mma; and an f32 q over the same K/V still runs rows (1e-4).

    q8mma keeps p in f32, as the reference's f32 p against the f32
    dequantized V does, through its hi/mid/lo split of p * v_scale; the
    plain version with the bf16 q rounds p to bf16 instead, so 5e-2 alone
    cannot see the split. So its output is also held to the plain
    version with q taken to f32 (every operand f32), rounded once to
    bf16: within one bf16 step at the largest output, 2^-8 max |ref|,
    and equal in at least 99% of the elements (f32 sums in another order
    flip a rounding only next to a tie). The body with hi alone leaves
    that limit: its model matches in fewer than 70% of the elements
    (test_torch_decode_attention.py::test_q8mma_split_is_what_keeps_p_in_f32)."""
    b, h, s = 6, 3, 256
    lens = torch.linspace(0, s - t, b).int().cuda()
    q = _randn((b, t, h, d), t + d, torch.bfloat16)
    if ps is None:
        k, v = (quantize_kv(_randn((b, s, h, d), seed, torch.bfloat16)) for seed in (1, 2))
        run = lambda x: tda.flash_decode_attention(x, k, v, lens, return_visited=True)  # noqa: E731
        plain = lambda x: tda.reference_decode_attention(x, k, v, lens)  # noqa: E731
        form, bk = "flash_decode_attention_int8", tda.pick_block_k(s)
    else:
        p = b * (s // ps) + 3
        k, v = (quantize_kv(_randn((p, ps, h, d), seed, torch.bfloat16)) for seed in (1, 2))
        bt = torch.randperm(p, generator=torch.Generator().manual_seed(t + d))[: b * (s // ps)]
        bt = bt.reshape(b, s // ps).int()
        bt[1, :2] = bt[0, :2]
        bt = bt.cuda()
        run = lambda x: tda.flash_paged_decode_attention(x, k, v, lens, bt, return_visited=True)  # noqa: E731
        plain = lambda x: tda.reference_paged_decode_attention(x, k, v, lens, bt)  # noqa: E731
        form, bk = "flash_paged_decode_attention_int8", tda.pick_block_k(ps)
    ref32 = plain(q.float()).float()
    for x, path, tol in ((q, "q8mma", 5e-2), (q.float(), "rows", 1e-4)):
        before = dict(tda.path_launches)
        out, vis = run(x)
        torch.cuda.synchronize()
        assert _path_delta(before) == {f"{form}/{path}": 1}
        assert out.dtype == x.dtype and bool(torch.isfinite(out).all())
        assert (out.float() - plain(x).float()).abs().max().item() <= tol
        assert torch.equal(vis.cpu(), tda.num_kv_blocks(lens.cpu(), t, s, bk))
        if path == "q8mma":
            step = 2.0**-8 * ref32.abs().max().item()
            assert (out.float() - ref32).abs().max().item() <= step
            share = (out.float() == ref32.bfloat16().float()).float().mean().item()
            assert share >= 0.99, share


@pytest.mark.parametrize("t", [1, 2, 64, 65, 128])
def test_decode_body_rule_and_smem_match_the_kernel_library(cuda, t):
    """The host's rule (``_decode_path``) and the C entry points'
    (``mpit_decode_path``, by whose answer a launch is counted) pick the
    same body for every q and K/V dtype at this query width; and
    ``_smem_bytes``, which the wrapper's refusal of a long block-table
    row reads, states what a block of that body takes on the card: the
    compiled kernel's static shared memory plus the dynamic bytes its
    launch asks for, at every head dim, dense and at 32 and 512 pages a
    slot."""
    lib = tda.kernel_library()
    for q_dtype, qc in tda._Q_DTYPES.items():
        for kv_dtype, kc in tda._KV_DTYPES.items():
            path = tda._decode_path(q_dtype, kv_dtype, t)
            assert tda._C_PATHS[lib.mpit_decode_path(qc, kc, t)] == path
            for d in tda._KERNEL_HEAD_DIMS:
                for n_ps in (0, 32, 512):
                    got = lib.mpit_decode_smem_bytes(qc, kc, t, d, n_ps)
                    want = tda._smem_bytes(path, d, n_ps, kv_dtype)
                    assert got == want, (q_dtype, kv_dtype, path, d, n_ps, got, want)


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


_QMM_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]  # GPT-2 small


@pytest.mark.parametrize(
    "m,d,f",
    [(m, d, f) for d, f in _QMM_SHAPES for m in (1, 8, 9, 64, 512, 1024)]
    + [
        (5, 100, 130),  # every tail ragged: element loads for x and q
        (9, 64, 72),  # F not a multiple of 16: element loads for q
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_matmul_kernel_matches_plain(cuda, m, d, f, dtype):
    """One launch, on the body the C library's plan names (``mma`` for
    bf16 x, ``fma`` for f32), within 1e-4 x max(1, max |plain|)."""
    x = _randn((m, d), 0, dtype)
    w = tqm.quantize_tensor(_randn((d, f), 1, torch.float32))
    plan = tqm.kernel_plan(m, d, f, dtype, x.device)
    assert plan["path"] == ("mma" if dtype == torch.bfloat16 else "fma")
    before, paths = tqm.launches["quantized_matmul"], dict(tqm.path_launches)
    out = tqm.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert tqm.launches["quantized_matmul"] == before + 1
    ran = {k: n - paths[k] for k, n in tqm.path_launches.items() if n != paths[k]}
    assert ran == {plan["path"]: 1}
    assert out.dtype == torch.float32 and out.shape == (m, f)
    ref = tqm.quantized_matmul_plain(x, w)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


def test_quantized_matmul_plan_fills_the_card_and_split_is_deterministic(cuda):
    """At every main-path shape (bf16 x, GPT-2 small's four layers at M 8,
    512 and 1024) the plan's grid holds at least a block an SM, and the
    split contraction (slices summed in order by the tile's last block)
    gives the same bits on every call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d, f in _QMM_SHAPES:
        w = tqm.quantize_tensor(_randn((d, f), 2, torch.float32))
        for m in (8, 512, 1024):
            plan = tqm.kernel_plan(m, d, f, torch.bfloat16, torch.device("cuda", 0))
            assert plan["path"] == "mma" and plan["blocks"] >= sms, (m, d, f, plan)
            x = _randn((m, d), 3, torch.bfloat16)
            first = tqm.quantized_matmul(x, w)
            for _ in range(3):
                assert torch.equal(tqm.quantized_matmul(x, w), first), (m, d, f, plan)
    assert tqm.kernel_plan(8, 3072, 768, torch.bfloat16, torch.device("cuda", 0))["splits"] > 1


@pytest.mark.parametrize("threads", [4, 8])
def test_quantized_matmul_from_many_threads_equals_alone(cuda, threads):
    """The fleet's case: several threads call the matmul at once, each
    with M growing (1, 8, 64, 512, 1024) over GPT-2 small's four shapes,
    from a fresh workspace, so wider calls grow the split contraction's
    shared workspace while narrower ones launch. Every result equals the
    same call made alone, bit for bit, and the launch counts are exact:
    plan, workspace, launch and count are one critical section a device."""
    import threading

    ms = (1, 8, 64, 512, 1024)
    weights = [tqm.quantize_tensor(_randn((d, f), 20 + i, torch.float32))
               for i, (d, f) in enumerate(_QMM_SHAPES)]
    xs = {(m, d): _randn((m, d), 30 + m + d, torch.bfloat16) for m in ms for d in (768, 3072)}
    calls = [(m, i) for m in ms for i in range(len(_QMM_SHAPES))]

    def call(m, i):
        return tqm.quantized_matmul(xs[m, _QMM_SHAPES[i][0]], weights[i])

    alone = {c: call(*c) for c in calls}
    torch.cuda.synchronize()
    tqm._SCRATCH.clear()  # the threads start from an empty workspace
    before = (tqm.launches["quantized_matmul"], dict(tqm.path_launches))
    start = threading.Barrier(threads)
    got = [dict() for _ in range(threads)]

    def work(t):
        start.wait()
        for c in calls[t % 2 :] + calls[: t % 2]:
            got[t][c] = call(*c)

    pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=120)
    torch.cuda.synchronize()
    assert all(len(g) == len(calls) for g in got)
    for g in got:
        for c, out in g.items():
            assert torch.equal(out, alone[c]), c
    n = threads * len(calls)
    assert tqm.launches["quantized_matmul"] == before[0] + n
    assert tqm.path_launches["mma"] == before[1]["mma"] + n
    assert tqm.path_launches["fma"] == before[1]["fma"]


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize(
    "t,h,d,q_off,k_off",
    [
        (128, 2, 64, 0, 0),
        (256, 3, 16, 0, 0),
        (128, 2, 64, 100, 0),  # each query block sees two key blocks
        (128, 2, 128, 0, 128),  # the key block wholly in the future
    ],
)
def test_flash_kernels_match_plain(cuda, dtype, tol, t, h, d, q_off, k_off):
    """Forward, dq and dk/dv kernels against their plain versions, with a
    non-zero lse cotangent folded into delta; each launches once.
    Absolute tolerance: bf16 outputs are rounded once at the end, in
    sums taken in another order, one bf16 step at their magnitudes."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    q, k, v, do = (_randn((2, t, h, d), s, dtype) for s in range(4))
    g_lse = _randn((2, h, t), 4, torch.float32)
    geo = dict(q_offset=q_off, k_offset=k_off, causal=True)
    before = dict(tfa.launches)
    o, lse = tfa.flash_fwd(q, k, v, q_off, k_off, True)
    delta = tfa._delta(o, do, g_lse)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True)
    torch.cuda.synchronize()
    assert {n: tfa.launches[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    want_o, want_lse = tfa.flash_fwd_plain(q, k, v, **geo)
    want = {
        "o": want_o, "lse": want_lse,
        "dq": tfa.flash_dq_plain(q, k, v, do, want_lse, delta, **geo),
        **dict(zip(("dk", "dv"), tfa.flash_dkv_plain(q, k, v, do, want_lse, delta, **geo))),
    }
    for name, got in {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}.items():
        ref = want[name].float()
        err = (got.float() - ref).abs().max().item()
        assert err <= tol, (name, err)
    if k_off >= q_off + t:
        assert bool((o == 0).all()) and bool((lse == -1e30).all())


@pytest.mark.parametrize("fused", [False, True], ids=["copies", "fused_qkv"])
@pytest.mark.parametrize(
    "t,q_off,k_off",
    [(100, 0, 0), (128, 0, 0), (512, 0, 0), (128, 100, 0), (100, 0, 100), (128, 0, 128)],
)
def test_flash_forward_mma_matches_plain(cuda, t, q_off, k_off, fused):
    """The bf16 forward (the tensor-core body) at ragged and whole tile
    counts, with offsets (partly visible tiles; a key block wholly in
    the future) and q, k, v as views of one fused qkv tensor: o within
    5e-2 of the plain forward, and the f32 lse within 1e-4, tight enough
    to see l summed from rounded p (about 1e-3); a future block gives
    o = 0 and lse = -1e30 exactly."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    h, d = 3, 64
    q, k, v = (_randn((2, t, h, d), s, torch.bfloat16) for s in range(3))
    if fused:
        q, k, v = torch.cat((q, k, v), dim=2).split(h, dim=2)
    before = tfa.launches["fwd"]
    o, lse = tfa.flash_fwd(q, k, v, q_off, k_off, True)
    torch.cuda.synchronize()
    assert tfa.launches["fwd"] == before + 1
    want_o, want_lse = tfa.flash_fwd_plain(q, k, v, q_offset=q_off, k_offset=k_off)
    assert (o.float() - want_o.float()).abs().max().item() <= 5e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
    if k_off >= q_off + t:
        assert bool((o == 0).all()) and bool((lse == -1e30).all())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "t,q_off,k_off,fused",
    [
        (65, 0, 0, False),  # a ragged key tile of one row
        (512, 0, 0, True),  # the model's fused qkv views, read in place
        (1024, 0, 0, False),
        (512, 256, 0, False),  # every key tile sees the query tiles from its own
        (512, 0, 512, False),  # keys wholly in the queries' future
    ],
)
def test_flash_dkv_mma_matches_plain(cuda, d, t, q_off, k_off, fused):
    """The bf16 dk/dv kernel (the tensor-core body) against its plain
    version, fed by the plain forward's lse and delta with a non-zero
    lse cotangent: dk and dv within 5e-2 (bf16 outputs rounded once,
    after sums taken in another order), one dkv launch; keys wholly in
    the future give exactly 0."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    b, h = 2, 3
    q, k, v, do = (_randn((b, t, h, d), s + d, torch.bfloat16) for s in range(4))
    if fused:
        q, k, v = torch.cat((q, k, v), dim=2).split(h, dim=2)
    geo = dict(q_offset=q_off, k_offset=k_off, causal=True)
    o, lse = tfa.flash_fwd_plain(q, k, v, **geo)
    delta = tfa._delta(o, do, _randn((b, h, t), 9, torch.float32))
    before = tfa.launches["dkv"]
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True)
    torch.cuda.synchronize()
    assert tfa.launches["dkv"] == before + 1
    want = tfa.flash_dkv_plain(q, k, v, do, lse, delta, **geo)
    for got, ref in zip((dk, dv), want):
        assert got.dtype == torch.bfloat16
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 5e-2, err
    if k_off >= q_off + t:
        assert not dk.any() and not dv.any()


def test_flash_body_rule_matches_the_kernel_library(cuda):
    """The host's rule (``_path``) and the C library's
    (``mpit_flash_path``: the body each launch takes, and by whose answer
    it is counted) name the same body for the forward, dq and dk/dv at
    each dtype: ``mma`` for bf16, ``fma`` for f32."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    lib = tfa.kernel_library()
    for code, kind in enumerate(tfa._C_KINDS):
        for dtype, dc in tfa._DTYPES.items():
            want = "mma" if dtype == torch.bfloat16 else "fma"
            assert tfa._C_PATHS[lib.mpit_flash_path(code, dc)] == tfa._path(dtype) == want, kind


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "t,q_off,k_off,fused",
    [
        (65, 0, 0, False),  # a ragged query tile of one row
        (512, 0, 0, True),  # the model's fused qkv views, read in place
        (1024, 0, 0, False),
        (512, 256, 0, False),  # every query tile sees the key tiles up to its own
        (512, 0, 512, False),  # keys wholly in the queries' future
    ],
)
def test_flash_dq_mma_matches_plain(cuda, d, t, q_off, k_off, fused):
    """The bf16 dq kernel (the tensor-core body) against its plain
    version, fed by the plain forward's lse and delta with a non-zero
    lse cotangent: dq within 5e-2 (a bf16 output rounded once, after
    sums taken in another order), one dq launch on the ``mma`` body;
    keys wholly in the future give exactly 0."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    b, h = 2, 3
    q, k, v, do = (_randn((b, t, h, d), s + 2 * d, torch.bfloat16) for s in range(4))
    if fused:
        q, k, v = torch.cat((q, k, v), dim=2).split(h, dim=2)
    geo = dict(q_offset=q_off, k_offset=k_off, causal=True)
    o, lse = tfa.flash_fwd_plain(q, k, v, **geo)
    delta = tfa._delta(o, do, _randn((b, h, t), 10, torch.float32))
    before = dict(tfa.path_launches)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True)
    torch.cuda.synchronize()
    ran = {n: tfa.path_launches[n] - before[n] for n in before if tfa.path_launches[n] != before[n]}
    assert ran == {"dq/mma": 1}
    assert dq.dtype == torch.bfloat16
    want = tfa.flash_dq_plain(q, k, v, do, lse, delta, **geo)
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= 5e-2, err
    if k_off >= q_off + t:
        assert not dq.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_read_fused_qkv_views_in_place(cuda, dtype):
    """q, k, v as strided views of one fused qkv tensor (the model's
    layout) give bit for bit what their contiguous copies give."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    q, k, v, do = (_randn((2, 128, 3, 64), s, dtype) for s in range(4))
    views = torch.cat((q, k, v), dim=2).split(3, dim=2)
    assert not views[1].is_contiguous()
    out = {}
    for label, (a, b, c) in (("views", views), ("copies", (q, k, v))):
        o, lse = tfa.flash_fwd(a, b, c)
        delta = tfa._delta(o, do, None)
        out[label] = (o, lse, tfa.flash_dq(a, b, c, do, lse, delta),
                      *tfa.flash_dkv(a, b, c, do, lse, delta))
    for x, y in zip(out["views"], out["copies"]):
        assert torch.equal(x, y)


def test_flash_attention_autograd_through_kernels(cuda):
    """``flash_attention_block``'s gradients on the card (kernels) equal
    the CPU's (plain versions) in f32, the lse term included."""
    from mpit_tpu_torch.ops import flash_attention as tfa

    grads = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (_randn((1, 128, 2, 64), s, torch.float32).to(dev).requires_grad_() for s in range(3))
        o, lse = tfa.flash_attention_block(q, k, v, q_offset=64, k_offset=0, block_q=64, block_k=64)
        w = _randn((1, 128, 2, 64), 5, torch.float32).to(dev)
        (o * w).sum().add((lse.sin()).sum()).backward()
        grads[dev] = [x.grad.cpu() for x in (q, k, v)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(*(_randn((1, 96, 2, 64), s, torch.float32) for s in range(3)), block_q=64)


def test_tiny_training_through_flash_kernels_matches_plain(cuda):
    """Three goo_adam steps of a tiny f32 GPT-2 (head dim 16) through
    the flash kernels and through the plain attention, from the same
    weights: per-step losses within 1e-4 relative; each kernel ran once
    per layer and step."""
    import dataclasses

    from mpit_tpu_torch.data import SyntheticLM
    from mpit_tpu_torch.models import default_attention
    from mpit_tpu_torch.ops import flash_attention as tfa
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.train import make_train_step

    cfg = GPT2Config.tiny(
        vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
        dtype=torch.float32,
    )
    init = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    losses = {}
    for label, attn in (("flash", tfa.flash_attention), ("plain", default_attention)):
        model = GPT2(dataclasses.replace(cfg, attention_fn=attn), device="cuda")
        model.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            lambda p, b: (GPT2.fused_loss_fn(model, b["tokens"]), {}), goo_adam(1e-3)
        )
        state = init_fn(dict(model.named_parameters()))
        batches = SyntheticLM(vocab_size=128, seed=0).batches(4, 64)
        before = dict(tfa.launches)
        losses[label] = []
        for _ in range(3):
            tokens = torch.from_numpy(next(batches)["tokens"]).long().cuda()
            state, metrics = step_fn(state, {"tokens": tokens})
            losses[label].append(metrics["loss"].item())
        ran = {n: tfa.launches[n] - before[n] for n in before}
        assert ran == dict.fromkeys(ran, 6 if label == "flash" else 0)
    np.testing.assert_allclose(losses["flash"], losses["plain"], rtol=1e-4)


# ---- the ring collectives (kernel B1) ---------------------------------------


def _ring_input(shape, dtype, seed, kind="normal"):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda")
    if kind == "int":
        x = torch.round(x * 4)
    elif kind == "zeros":
        x.zero_()
    return x.to(dtype)


def _bits(t):
    """``t``'s elements as integers of their width: equal bits, signed
    zeros too, where ``torch.equal`` of the floats takes -0 for +0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _moved(before, counts):
    return {k: n - before[k] for k, n in counts.items() if n != before[k]}


@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["sum", "q8"])
@pytest.mark.parametrize("rows", [1, 37, 256])
def test_ring_kernels_equal_plain_bitwise(cuda, p, dtype, form, rows):
    """Every form, bit-equal to its plain version (the same ring order,
    the same roundings); each launch counted once per call, and a q8
    kind's once by the form the C library's plan names. ``sum``: the
    one-card fold and copy; ``q8``: the q8 fold and the q8 copy. The
    all-gather also writes into an ``out=`` slice of a wider buffer and
    leaves the rest of it as it was."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    quantized = form == "q8"
    q = "_q8" if quantized else ""
    dev = torch.device("cuda", 0)

    def forms(kind):
        return {rc.q8_plan(kind, p, rows, dtype, dev)["form"]: 1} if quantized else {}

    xs = _ring_input((p, p, rows, 128), dtype, p * rows + quantized)
    before, before_forms = dict(rc.launches), dict(rc.path_launches)
    got = rc.reduce_scatter_chunks(xs, quantized=quantized)
    torch.cuda.synchronize()
    assert _moved(before, rc.launches) == {f"ring_rs{q}": 1}
    assert _moved(before_forms, rc.path_launches) == forms(f"ring_rs{q}")
    assert torch.equal(got, rc.reduce_scatter_plain(xs, quantized=quantized))
    shards = _ring_input((p, rows, 128), dtype, 7 + p + rows)
    before, before_forms = dict(rc.launches), dict(rc.path_launches)
    full = rc.all_gather_chunks(shards, quantized=quantized)
    torch.cuda.synchronize()
    assert _moved(before, rc.launches) == {f"ring_ag{q}": 1}
    assert _moved(before_forms, rc.path_launches) == forms(f"ring_ag{q}")
    assert torch.equal(_bits(full), _bits(rc.all_gather_plain(shards, quantized=quantized)))
    for r in range(1, p):
        assert torch.equal(_bits(full[r]), _bits(full[0]))
    wide = torch.full((p, p, rows + 5, 128), 7.0, dtype=dtype, device="cuda")
    rc.all_gather_chunks(shards, quantized=quantized, out=wide[:, :, 2 : 2 + rows])
    torch.cuda.synchronize()
    assert torch.equal(wide[:, :, 2 : 2 + rows], full)
    assert (wide[:, :, :2] == 7).all() and (wide[:, :, 2 + rows :] == 7).all()


def test_ring_kernels_take_strided_buckets_and_zero_chunks(cuda):
    """Row ranges of flat buffers read and written in place (the bucket
    loop), an all-zero chunk (scale 1), many calls on one workspace."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    p, rows = 4, 96
    xs = _ring_input((p, p, rows, 128), torch.float32, 3)
    xs[:, 1] = 0  # chunk 1 is zero on every rank: its q8 sum too
    for quantized in (False, True):
        out = torch.zeros(p, rows, 128, device="cuda")
        for r0, r1 in ((0, 32), (32, 64), (64, 96)):
            rc.reduce_scatter_chunks(xs[:, :, r0:r1], quantized=quantized, out=out[:, r0:r1])
        want = torch.cat([rc.reduce_scatter_plain(xs[:, :, a:b], quantized=quantized)
                          for a, b in ((0, 32), (32, 64), (64, 96))], dim=1)
        assert torch.equal(out, want)
        assert not out[1].any()
        full = torch.zeros(p, p, rows, 128, device="cuda")
        for r0, r1 in ((0, 32), (32, 96)):
            rc.all_gather_chunks(out[:, r0:r1], quantized=quantized, out=full[:, :, r0:r1])
        want = torch.cat([rc.all_gather_plain(out[:, a:b], quantized=quantized)
                          for a, b in ((0, 32), (32, 96))], dim=2)
        assert torch.equal(full, want)
    assert rc.device_error() is None


@pytest.mark.parametrize("p", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 37, 8192])
def test_q8_fold_forms_equal_plain_bitwise(cuda, p, dtype, rows):
    """The q8 fold on the form the C library's plan names (``resident``
    where a block's rows of the partials fit in shared memory: p 2 and 4
    at GPT-2 small's 8192-row bucket; ``stream`` where they do not: p 8
    and 16 there), bit-equal to ``reduce_scatter_plain(quantized=True)``
    (signed zeros too: lane 0 is -0 in every copy, so each hop's partial
    there quantizes to an int8 zero, which has no sign, and adds -0);
    with a zero chunk; two calls in a row give the same bits (the amax
    barrier's epoch tokens); one launch a call, counted by its form."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    plan = rc.q8_plan("ring_rs_q8", p, rows, dtype, torch.device("cuda", 0))
    if rows == 8192:
        assert plan["form"] == ("q8fold_resident" if p <= 4 else "q8fold_stream")
    xs = _ring_input((p, p, rows, 128), dtype, 40 + p + rows)
    xs[:, p // 2] = 0
    xs[..., 0] = -0.0
    want = rc.reduce_scatter_plain(xs, quantized=True)
    before = dict(rc.path_launches)
    first = rc.reduce_scatter_chunks(xs, quantized=True)
    second = rc.reduce_scatter_chunks(xs, quantized=True)
    torch.cuda.synchronize()
    assert _moved(before, rc.path_launches) == {plan["form"]: 2}
    assert torch.equal(_bits(first), _bits(want)) and torch.equal(_bits(second), _bits(want))
    assert not first[p // 2].any()
    assert rc.device_error() is None


def test_q8_fold_quotient_equals_ieee_division(cuda):
    """The q8 fold divides by a hop's scale as a product with its
    reciprocal corrected once by the fma residual: bit-equal to
    ``__fdiv_rn`` for 16M random pairs (scales ``amax / 127`` over 56
    decades, |p| <= amax, as a hop sees them) and 8M pairs within four
    ulps of a half-integer quotient, where a wrong last bit would move
    the int8 rounding."""
    import ctypes

    from mpit_tpu_torch.ops import ring_collectives as rc

    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 1 << 24
    amax = torch.pow(10.0, torch.rand(n, generator=gen, device="cuda") * 56 - 28)
    s = amax / torch.tensor(127.0, device="cuda")
    p = (torch.rand(n, generator=gen, device="cuda") * 2 - 1) * amax
    k = torch.randint(-127, 127, (n // 16,), generator=gen, device="cuda").float() + 0.5
    ties_s = s[: n // 16]
    ties = k * ties_s
    near_p, near_s = [ties], [ties_s]
    for direction in (1.0, -1.0):
        v = ties
        for _ in range(4):
            v = torch.nextafter(v, torch.full_like(v, direction * float("inf")))
            near_p.append(v)
            near_s.append(ties_s)
    p = torch.cat([p, *near_p]).contiguous()
    s = torch.cat([s, *near_s]).contiguous()
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    lib = rc.kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.mpit_q8_quot_mismatches(p.data_ptr(), s.data_ptr(), p.numel(),
                                       count.data_ptr(), ctypes.c_void_p(stream)) == 0
    torch.cuda.synchronize()
    assert count.item() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_fold_reads_the_tail_bucket_in_place(cuda, dtype):
    """GPT-2 small's ragged tail bucket, read in place from a wider
    buffer (the bucket loop's strided chunks), on both forms."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    for p in (4, 8):
        wide = _ring_input((p, p, 8192 + 3000, 128), dtype, 50 + p)
        xs = wide[:, :, 8192:]
        out = torch.full((p, 3000 + 4, 128), 7.0, device="cuda")
        rc.reduce_scatter_chunks(xs, quantized=True, out=out[:, 2 : 2 + 3000])
        torch.cuda.synchronize()
        assert torch.equal(out[:, 2 : 2 + 3000], rc.reduce_scatter_plain(xs, quantized=True))
        assert (out[:, :2] == 7).all() and (out[:, 2 + 3000 :] == 7).all()
    assert rc.q8_plan("ring_rs_q8", 8, 8192, dtype, torch.device("cuda", 0))["form"] == (
        "q8fold_stream")


@pytest.mark.parametrize("p", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 37, 8192])
def test_q8_gather_forms_equal_plain_bitwise(cuda, p, dtype, rows):
    """The q8 all-gather as the q8 copy on the form the C library's plan
    names (``resident`` where a block's rows of the shard, in its dtype,
    fit in shared memory: f32 to p 4 and bf16 to p 8 at GPT-2 small's
    8192-row bucket; ``stream`` beyond), bit-equal to
    ``all_gather_plain(quantized=True)`` (signed zeros too), every
    replica identical: with an all-zero chunk and a chunk whose amax lies
    in its last block only, read in place from a wider buffer (the bucket
    loop's strided shards) and written into an ``out=`` slice, then a
    second call on the same workspace; one launch a call, counted by its
    form."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    plan = rc.q8_plan("ring_ag_q8", p, rows, dtype, torch.device("cuda", 0))
    if rows == 8192:
        resident = p <= (4 if dtype == torch.float32 else 8)
        assert plan["form"] == ("q8copy_resident" if resident else "q8copy_stream")
    wide = _ring_input((p, rows + 3, 128), dtype, 60 + p + rows)
    shards = wide[:, 2 : 2 + rows]
    shards[p - 1] = 0
    shards[0] *= 1e-3  # its amax, 5.0, in the last row: the last block's
    shards[0, -1, 7] = 5.0
    want = rc.all_gather_plain(shards, quantized=True)
    out = torch.full((p, p, rows + 4, 128), 7.0, dtype=dtype, device="cuda")
    before = dict(rc.path_launches)
    rc.all_gather_chunks(shards, quantized=True, out=out[:, :, 1 : 1 + rows])
    second = rc.all_gather_chunks(shards, quantized=True)
    torch.cuda.synchronize()
    assert _moved(before, rc.path_launches) == {plan["form"]: 2}
    first = out[:, :, 1 : 1 + rows]
    assert torch.equal(_bits(first), _bits(want)) and torch.equal(_bits(second), _bits(want))
    for r in range(1, p):
        assert torch.equal(_bits(first[r]), _bits(first[0]))
    assert (out[:, :, :1] == 7).all() and (out[:, :, 1 + rows :] == 7).all()
    assert not first[:, p - 1].any() and (first[:, 0, -1, 7] == 5.0).all()
    assert rc.device_error() is None


def test_ring_public_collectives_and_refusals(cuda):
    from mpit_tpu_torch.ops import ring_collectives as rc
    from mpit_tpu_torch.ops.ring_allreduce import ring_allreduce

    x = _ring_input((4, 3000), torch.float32, 11, kind="int")
    np.testing.assert_array_equal(
        rc.ring_reduce_scatter(x).cpu().numpy(),
        rc.ring_reduce_scatter(x.cpu()).numpy(),
    )
    full = ring_allreduce(x)
    assert torch.equal(full.cpu(), ring_allreduce(x.cpu()))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rc.reduce_scatter_chunks(torch.zeros(2, 2, 8, 128, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="2 to 16 ranks"):
        rc.all_gather_chunks(torch.zeros(17, 8, 128, device="cuda"))
    with pytest.raises(ValueError, match="dense"):
        rc.all_gather_chunks(torch.zeros(2, 8, 256, device="cuda")[..., :128])


@pytest.mark.parametrize("mode", ["ring", "ring_q8"])
def test_tiny_data_parallel_training_through_ring_kernels(cuda, mode):
    """Four ranks on the card, three goo_adam steps of a tiny f32 GPT-2:
    ``ring`` within 1e-5 relative of ``psum`` (the sums are taken in
    another order), ``ring_q8`` within 0.02 + 0.02·|loss|; replicas
    bit-identical; one reduce-scatter and one all-gather launch a bucket
    and step."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.data import SyntheticLM, shard_batch
    from mpit_tpu_torch.ops import ring_collectives as rc
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.train import make_train_step

    world = comm.init({"data": 4}, devices=["cuda"])
    cfg = GPT2Config.tiny(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
                          d_model=32, dtype=torch.float32)
    init = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    losses = {}
    for label in ("psum", mode):
        models = [GPT2(cfg, device="cuda") for _ in range(4)]
        for m in models:
            m.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            [lambda p, b, m=m: (GPT2.fused_loss_fn(m, b["tokens"].long()), {}) for m in models],
            goo_adam(1e-3), world, grad_sync=label, grad_bucket_mb=0.01,
        )
        state = init_fn([dict(m.named_parameters()) for m in models])
        batches = SyntheticLM(vocab_size=128, seed=0).batches(8, 32)
        before = dict(rc.launches)
        losses[label] = []
        for _ in range(3):
            state, metrics = step_fn(state, shard_batch(world, next(batches)))
            losses[label].append(metrics["loss"].item())
        assert state.replicas_equal()
        ran = {k: rc.launches[k] - before[k] for k in before}
        if label != "psum":
            gs = step_fn.grad_sync
            n_buckets = len(gs.bucket_rows(state.flat.params.shape[1] // (4 * 128)))
            q = "_q8" if label == "ring_q8" else ""
            assert ran[f"ring_rs{q}"] == ran[f"ring_ag{q}"] == 3 * n_buckets > 3
            assert step_fn.grad_sync_mode == label
        else:
            assert not any(ran.values())
    if mode == "ring":
        np.testing.assert_allclose(losses["ring"], losses["psum"], rtol=1e-5)
    else:
        for a, b in zip(losses["psum"], losses[mode]):
            assert abs(a - b) <= 0.02 + 0.02 * abs(a)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4711, 2 * 12 * 128 * 12 * 64])
@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (1, 1), (1, 3), (3, 1), (8, 0), (0, 4), (6, 2)])
def test_kv_ship_kernel_copies_bit_exact(cuda, n, src_off, dst_off):
    """The KV shipment's copy kernel: every byte, at every mutual
    alignment (16-byte vectors, the narrower words, bytes), nothing
    written outside dst; one launch a call."""
    from mpit_tpu_torch.ops import kv_ship

    gen = torch.Generator(device="cuda").manual_seed(n + src_off)
    src = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device="cuda", generator=gen)
    dst = torch.zeros(n + 16, dtype=torch.uint8, device="cuda")
    before = kv_ship.launches["kv_ship"]
    kv_ship.ship_bytes(src[src_off:src_off + n], dst[dst_off:dst_off + n])
    torch.cuda.synchronize()
    assert kv_ship.launches["kv_ship"] == before + 1
    assert torch.equal(dst[dst_off:dst_off + n], src[src_off:src_off + n])
    assert not dst[:dst_off].any() and not dst[dst_off + n:].any()


@pytest.mark.parametrize("n", [1, 15, 17, 4711, 4_718_592, 2_506_752, 64 * 2**20])
@pytest.mark.parametrize("src_off", [0, 1, 3, 8])
@pytest.mark.parametrize("dst_off", [0, 1, 3, 8])
def test_kv_ship_bodies_copy_bit_exact(cuda, n, src_off, dst_off):
    """Both bodies the plan can pick (``wave`` below 32 MiB, ``stream``
    from there), and the plan's own choice, at every offset pair: every
    byte copied, nothing written outside dst, one launch a call, counted
    by its body."""
    from mpit_tpu_torch.ops import kv_ship

    gen = torch.Generator(device="cuda").manual_seed(n + 16 * src_off + dst_off)
    src = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device="cuda", generator=gen)
    s = src[src_off : src_off + n]
    for body in (*kv_ship.BODIES, None):
        dst = torch.zeros(n + 16, dtype=torch.uint8, device="cuda")
        d = dst[dst_off : dst_off + n]
        ran = kv_ship.kernel_plan(s, d, body)["body"]
        assert ran == (body or ("stream" if n >= 32 * 2**20 else "wave"))
        before = (kv_ship.launches["kv_ship"], dict(kv_ship.path_launches))
        kv_ship.ship_bytes(s, d, body=body)
        torch.cuda.synchronize()
        assert kv_ship.launches["kv_ship"] == before[0] + 1
        assert kv_ship.path_launches[ran] == before[1][ran] + 1
        assert torch.equal(d, s)
        assert not dst[:dst_off].any() and not dst[dst_off + n :].any()


def test_kv_ship_dtypes_refusals_and_remote(cuda):
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.serve.shipment import ship_kv_remote

    x = torch.randn(3, 5, 7, device="cuda").to(torch.bfloat16)
    out = ship_kv_remote(x, 0)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    assert torch.equal(ship_kv_remote(x, "cuda"), x)
    with pytest.raises(ValueError, match="contiguous"):
        kv_ship.ship_bytes(x.transpose(0, 1), torch.empty_like(x))
    with pytest.raises(ValueError, match="one device"):
        kv_ship.ship_bytes(x, torch.empty_like(x, device="cpu"))
    with pytest.raises(ValueError, match="bytes"):
        kv_ship.ship_bytes(x, torch.empty(3, 5, 7, device="cuda"))
    with pytest.raises(ValueError, match="overlap"):
        kv_ship.ship_bytes(x.view(-1)[:10], x.view(-1)[5:15])
    if torch.cuda.device_count() < 2:
        with pytest.raises(NotImplementedError, match="§A 14"):
            ship_kv_remote(x, 1)


def test_compat_moves_cuda_messages_through_the_kernel(cuda):
    """A CUDA Send and its delivery into a CUDA buffer: two kernel
    launches; a CUDA message never lands in a CPU buffer."""
    from mpit_tpu_torch import compat as mpiT
    from mpit_tpu_torch.ops import kv_ship

    payload = torch.arange(4711, dtype=torch.int32, device="cuda")

    def main():
        mpiT.Init()
        if mpiT.Comm_rank() == 0:
            mpiT.Send(payload, dest=1, tag=1)
            mpiT.Send(payload, dest=1, tag=2)
            mpiT.Barrier()  # both queued before rank 1 receives
            return None
        mpiT.Barrier()
        buf = torch.zeros_like(payload)
        st = mpiT.Recv(buf, src=0, tag=1)
        try:
            mpiT.Recv(torch.zeros(4711, dtype=torch.int32), src=0, tag=2)
        except TypeError as e:
            return st.count, buf.cpu(), str(e)
        return None

    before = kv_ship.launches["kv_ship"]
    out = mpiT.run(main, 2, timeout=60)
    count, got, err = out[1]
    assert count == 4711 and torch.equal(got, payload.cpu())
    assert "device" in err
    assert kv_ship.launches["kv_ship"] == before + 3  # two snapshots, one delivery


@pytest.mark.parametrize("geo", [
    dict(slots=2, max_len=32, prefill_len=8),
    dict(slots=2, max_len=40, prefill_len=8, kv_pages=24, kv_page_size=4,
         prefill_chunk=4, kv_dtype="int8"),
], ids=["dense", "paged-int8"])
def test_tiny_fleet_on_the_card_equals_server(cuda, geo):
    """A tiny f32 fleet (router, one prefill and two decode workers) on
    the card: the single Server's greedy tokens, and two copy-kernel
    launches a shipment (the send snapshot and the delivery)."""
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.serve import run_fleet

    cfg = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
                          d_model=32, dtype=torch.float32)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    prompts = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]

    def requests():
        return [Request(rid=f"r{i}", prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, [6, 4, 8, 3, 5, 7]))]

    server = Server(Engine(cfg, state, device="cuda", **geo))
    for r in requests():
        server.submit(r)
    want = {str(c.rid): list(c.tokens) for c in server.run()}
    before = kv_ship.launches["kv_ship"]
    out = run_fleet(lambda role, rank: Engine(cfg, state, device="cuda", **geo),
                    requests(), prefill=1, decode=2, heartbeat_s=0.05, lease_s=5.0,
                    job_timeout_s=60.0)
    assert out["completed"] == want
    shipments = sum(w.get("processed", 0) for w in out["workers"])
    assert shipments == len(prompts)
    assert kv_ship.launches["kv_ship"] - before == 2 * shipments


# ---- the convnet slice: B1 at its bucket plans, B5 at its flat message --------


def _convnet_bucket_plan(model, p=4):
    """The ZeRO-1 shard's rows over ``p`` ranks and the bucket rows of
    ``model``'s flat layout (4 MB buckets, the default)."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
    from mpit_tpu_torch.train.grad_sync import GradSync

    layout = FlatLayout(dict(model.named_parameters()))
    rows = padded_len(layout.total, p) // (p * 128)
    world = comm.init({"data": p}, devices=["cuda"])
    return rows, GradSync(world, "ring").bucket_rows(rows)


@pytest.mark.parametrize("net", ["alexnet", "lenet", "resnet50"])
@pytest.mark.parametrize("form", ["sum", "q8"])
def test_ring_kernels_at_the_convnet_bucket_plans(cuda, net, form):
    """AlexNet at p 4: 15 buckets of its 119,338-row shard, a full
    8192-row one and the ragged tail (4650 rows) read in place from the
    flat buffer; LeNet: one 122-row bucket; ResNet-50: 7 buckets of its
    49,924-row shard, the tail 772 rows. Each kind bit-equal to its
    plain version."""
    from mpit_tpu_torch.models import AlexNet, LeNet, ResNet50
    from mpit_tpu_torch.ops import ring_collectives as rc

    p, quantized = 4, form == "q8"
    model = {"alexnet": AlexNet, "lenet": LeNet, "resnet50": ResNet50}[net](device="meta")
    rows, buckets = _convnet_bucket_plan(model, p)
    if net == "alexnet":
        assert (rows, len(buckets), buckets[-1][1] - buckets[-1][0]) == (119_338, 15, 4650)
        picked = [buckets[0], buckets[-1]]
    elif net == "resnet50":
        assert (rows, len(buckets), buckets[-1][1] - buckets[-1][0]) == (49_924, 7, 772)
        picked = [buckets[0], buckets[-1]]
    else:
        assert buckets == [(0, 122)]
        picked = buckets
    wide = _ring_input((p, p, rows, 128), torch.float32, 90 + quantized)
    for r0, r1 in picked:
        xs = wide[:, :, r0:r1]
        got = rc.reduce_scatter_chunks(xs, quantized=quantized)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(rc.reduce_scatter_plain(xs, quantized=quantized)))
        shards = got[:, : r1 - r0]
        full = rc.all_gather_chunks(shards, quantized=quantized)
        torch.cuda.synchronize()
        assert torch.equal(_bits(full), _bits(rc.all_gather_plain(shards, quantized=quantized)))
    assert rc.device_error() is None


def test_kv_ship_at_the_alexnet_flat_message(cuda):
    """The parity protocol's AlexNet message, 61,101,056 f32 elements
    (244.4 MB): the copy kernel equals ``copy_`` bit for bit, on the
    ``stream`` body, one launch."""
    from mpit_tpu_torch.models import AlexNet
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.opt.sharded import FlatLayout

    n = FlatLayout(dict(AlexNet(device="meta").named_parameters())).total
    assert n == 61_101_056
    src = _ring_input((n,), torch.float32, 5)
    dst, want = torch.empty_like(src), torch.empty_like(src)
    assert kv_ship.kernel_plan(src, dst)["body"] == "stream"
    before = kv_ship.launches["kv_ship"]
    kv_ship.ship_bytes(src, dst)
    torch.cuda.synchronize()
    assert kv_ship.launches["kv_ship"] == before + 1
    want.copy_(src)
    assert torch.equal(_bits(dst), _bits(want))


@pytest.mark.parametrize("protocol", ["downpour", "easgd"])
def test_parameter_server_on_the_card_equals_the_cpu(cuda, protocol):
    """The parity actors with the flat vectors on the card: every reply
    and the final server parameters equal the CPU run's within 1e-6;
    every flat message is two copy-kernel launches (the send snapshot and
    the delivery), the control messages stay on the CPU."""
    from mpit_tpu_torch.asyncsgd import actors
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.ops import kv_ship

    rng = np.random.default_rng(3)
    n, rounds = 100_000, 4
    flat0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    payloads = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                for _ in range(rounds)]

    def run(device):
        def client(c, widx):
            replies = []
            for k, x in enumerate(payloads):
                x = x.to(device)
                if protocol == "downpour":
                    replies.append(c.fetch().clone())
                    c.push_grad(x)
                else:
                    replies.append(c.elastic_exchange(x + k, 0.25))
            return [r.cpu() for r in replies]

        return actors.run_parameter_server(flat0.to(device), goo(0.1, 0.9), client,
                                           nranks=2, easgd_alpha=0.25, timeout=60)

    before = kv_ship.launches["kv_ship"]
    got = run("cuda")
    torch.cuda.synchronize()
    assert kv_ship.launches["kv_ship"] - before == 4 * rounds
    want = run("cpu")
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert got[0].device.type == "cuda"
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-6)


# ---- the ResNet slice: the stateful step on the card -------------------------------


def _tiny_resnet(**kw):
    from mpit_tpu_torch.models import ResNet50

    return ResNet50(10, torch.float32, (1, 1, 1, 1), torch.float32, **kw)


def _resnet_steps(device, p, mode, init, batches):
    """Three stateful goo steps (lr 0.01, momentum 0.9, weight decay
    1e-4) of the tiny f32 ResNet on ``device``, one rank or ``p``;
    returns the losses, the state and the models."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.data import shard_batch
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.train import make_train_step

    models = [_tiny_resnet(device=device) for _ in range(p)]
    for m in models:
        m.load_state_dict(init)
    fns = [runner._classifier_fns(m, top5=False, stateful=True)[0] for m in models]
    world = None if p == 1 else comm.init({"data": p}, devices=[device])
    init_fn, step_fn = make_train_step(fns[0] if world is None else fns,
                                       goo(0.01, 0.9, weight_decay=1e-4), world,
                                       stateful=True, grad_sync=mode)
    named = [dict(m.named_parameters()) for m in models]
    bufs = [dict(m.named_buffers()) for m in models]
    state = init_fn(named[0], bufs[0]) if world is None else init_fn(named, bufs)
    losses = []
    for b in batches:
        b = ({k: torch.from_numpy(v).to(device) for k, v in b.items()} if world is None
             else shard_batch(world, b))
        state, m = step_fn(state, b)
        losses.append(m["loss"].item())
    return losses, state, models


@pytest.fixture
def deterministic_f32(cuda):
    """TF32 off, cuDNN deterministic, no autotuning; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def _resnet_case(p):
    from mpit_tpu_torch.data import synthetic_imagenet

    init = _tiny_resnet(generator=torch.Generator().manual_seed(0)).state_dict()
    stream = synthetic_imagenet(image_size=32, num_classes=10, seed=0).batches(8 * p)
    return init, [next(stream) for _ in range(3)]


def test_resnet_step_on_the_card_matches_the_cpu(deterministic_f32):
    """Three f32 stateful steps of the tiny ResNet on one rank: the
    card's losses within 1e-5 relative of the CPU's, every parameter and
    BatchNorm buffer within 1e-4 x max(1, max |cpu|) (cuDNN and the CPU
    sum the convolutions in other orders; the norms' gradients carry
    that into the updates)."""
    init, batches = _resnet_case(1)
    got, _, gm = _resnet_steps("cuda", 1, "psum", init, batches)
    want, _, wm = _resnet_steps("cpu", 1, "psum", init, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for (name, a), b in zip(gm[0].state_dict().items(), wm[0].state_dict().values()):
        tol = 1e-4 * max(1.0, b.abs().max().item())
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol, msg=name)


@pytest.mark.parametrize("mode", ["ring", "ring_q8"])
def test_resnet_replicas_and_statistics_bit_equal_over_four_ranks(deterministic_f32, mode):
    """The tiny ResNet over four ranks on the card through the ring
    kernels: after three steps every rank's parameters and BatchNorm
    buffers equal rank 0's bit for bit, the buffers moved from their
    start, and each ring kind launched buckets x steps times."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    init, batches = _resnet_case(4)
    before = dict(rc.launches)
    losses, state, models = _resnet_steps("cuda", 4, mode, init, batches)
    assert all(np.isfinite(losses))
    assert state.replicas_equal()
    for r in range(1, 4):
        for (name, a), b in zip(models[0].named_buffers(), models[r].buffers()):
            assert torch.equal(a, b), (r, name)
    assert not torch.equal(models[0].get_buffer("ScaleShiftBatchNorm_0.mean").cpu(),
                           init["ScaleShiftBatchNorm_0.mean"])
    q = "_q8" if mode == "ring_q8" else ""
    _, buckets = _convnet_bucket_plan(models[0], 4)
    assert len(buckets) == 2  # 15,703 shard rows: 8192 and 7511
    moved = {k: n - before[k] for k, n in rc.launches.items() if n != before[k]}
    assert moved == {f"ring_rs{q}": 3 * len(buckets), f"ring_ag{q}": 3 * len(buckets)}


# ---- the checkpoint and elastic slice ----------------------------------------------


def test_async_save_holds_the_state_from_before_the_next_step(cuda, tmp_path):
    """An asynchronous save of a CUDA state, followed at once by an
    in-place step that rewrites every buffer: the file holds the state
    from before the step (the snapshot's copies are ordered before it on
    the stream, the writer waits on their event)."""
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.train import CheckpointManager, TrainState

    n = 8 * 2**20
    params = {"w": torch.randn(n, device="cuda"), "b": torch.randn(1000, device="cuda")}
    tx = goo(0.1, 0.9)
    state = TrainState(step=3, params=params, opt_state=tx.init(params))
    before = {k: v.cpu() for k, v in params.items()}
    ck = CheckpointManager(tmp_path)
    ck.save(3, state)
    for _ in range(20):  # the next steps, enqueued at once behind the save's copies
        tx.step(params, {k: torch.ones_like(v) for k, v in params.items()}, state.opt_state)
    ck.wait()
    like = TrainState(step=0, params={k: torch.zeros_like(v) for k, v in params.items()},
                      opt_state=tx.init(params))
    ck.restore(like)
    for k, v in before.items():
        assert torch.equal(like.params[k].cpu(), v), k
    assert not torch.equal(params["w"].cpu(), before["w"])


def test_restore_into_a_bound_state_over_four_ranks(cuda, tmp_path):
    """LeNet over four ranks on the card (ZeRO-1 through ``ring``): three
    steps, a checkpoint, three more; a fresh state from another init,
    bound to its models, restored from the checkpoint and stepped three
    times equals the uninterrupted run bit for bit (TF32 off, cuDNN
    deterministic), the replicas equal after the restore."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.data import shard_batch, synthetic_mnist
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.train import CheckpointManager, make_train_step

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        world = comm.init({"data": 4}, devices=["cuda"])
        stream = synthetic_mnist(seed=0).batches(32)
        batches = [next(stream) for _ in range(6)]

        def fresh(seed):
            init = LeNet(generator=torch.Generator().manual_seed(seed)).state_dict()
            models = [LeNet(device="cuda") for _ in range(4)]
            for m in models:
                m.load_state_dict(init)
            init_fn, step_fn = make_train_step(
                [runner._classifier_fns(m, False)[0] for m in models], goo(0.05, 0.9), world,
                grad_sync="ring")
            return init_fn([dict(m.named_parameters()) for m in models]), step_fn

        state, step_fn = fresh(0)
        ck = CheckpointManager(tmp_path)
        for i, b in enumerate(batches):
            state, _ = step_fn(state, shard_batch(world, b))
            if i == 2:
                ck.save(3, state)
        ck.wait()
        other, step2 = fresh(1)
        ck.restore(other)
        assert other.step == 3 and other.replicas_equal()
        for b in batches[3:]:
            other, _ = step2(other, shard_batch(world, b))
        assert torch.equal(other.flat.params, state.flat.params)
        assert all(torch.equal(a, b) for a, b in zip(other.opt_state.momentum,
                                                     state.opt_state.momentum))
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved


def test_anchor_exchange_launches_counted_exactly(cuda):
    """Two replicas register and exchange with the anchor on the card:
    every flat message is a send snapshot and a delivery through the
    copy kernel, so a register costs two launches and an exchange four;
    the control messages (stop) none. The centre equals the CPU run's."""
    from mpit_tpu_torch import compat
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.train import elastic

    n, rounds = 50_000, 3
    init = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))

    def run(device):
        cfg = elastic.ElasticConfig(replicas=2, alpha=0.25, lease_s=30.0, heartbeat_s=1.0)
        order = [threading.Event() for _ in range(2 * rounds + 1)]
        order[0].set()

        def main(rank):
            if rank == 0:
                return elastic.anchor_server(init.to(device), cfg)
            client = elastic.AnchorClient(n, cfg, device=device)
            client.register(0)
            for k in range(rounds):
                turn = 2 * k + rank - 1
                order[turn].wait(30)
                client.exchange(torch.full((n,), float(rank + k), device=device), k)
                order[turn + 1].set()
            client.stop(rounds)
            return None

        return compat.run(main, 3, pass_rank=True, timeout=60)[0]

    before = kv_ship.launches["kv_ship"]
    got = run("cuda")
    torch.cuda.synchronize()
    assert kv_ship.launches["kv_ship"] - before == 2 * 2 + 4 * 2 * rounds
    want = run("cpu")
    assert got["version"] == want["version"] == 2 * rounds
    assert torch.equal(got["center"].cpu(), want["center"])


# ---- speculative decoding: the verify's shapes and the engine ----------------


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ps", [None, 4, 16], ids=["dense", "ps4", "ps16"])
@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_decode_bodies_at_verify_widths_match_plain(cuda, kv, ps, t):
    """The verify's query widths T = k + 1 (2 to 5) on each body (bf16
    q and K/V: mma; bf16 q over int8 K/V: q8mma; f32: rows), dense and
    paged (pages of 4 rows: the T rows straddle a page), with lengths 0,
    3, 100 and S - T; within q's tolerance of plain, launches on the body
    the rule names."""
    b, h, d, s = 4, 12, 64, 256
    dt = torch.float32 if kv == "f32" else torch.bfloat16
    q = _randn((b, t, h, d), t, dt)
    lens = torch.tensor([0, 3, 100, s - t], dtype=torch.int32, device="cuda")
    if ps is None:
        k, v = (_randn((b, s, h, d), seed, dt) for seed in (1, 2))
    else:
        p = b * (s // ps) + 3
        k, v = (_randn((p, ps, h, d), seed, dt) for seed in (1, 2))
        bt = torch.randperm(p, generator=torch.Generator().manual_seed(t))[: b * (s // ps)]
        bt = bt.reshape(b, s // ps).int().cuda()
    if kv == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    path = tda._decode_path(dt, torch.int8 if kv == "int8" else dt, t)
    assert path == {"f32": "rows", "bf16": "mma", "int8": "q8mma"}[kv]
    before = dict(tda.path_launches)
    if ps is None:
        out = tda.flash_decode_attention(q, k, v, lens)
        ref = tda.reference_decode_attention(q, k, v, lens)
    else:
        out = tda.flash_paged_decode_attention(q, k, v, lens, bt)
        ref = tda.reference_paged_decode_attention(q, k, v, lens, bt)
    torch.cuda.synchronize()
    assert sum(_path_delta(before).values()) == 1
    assert all(key.endswith("/" + path) for key in _path_delta(before))
    tol = 1e-4 if kv == "f32" else 5e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("d,f", _QMM_SHAPES)
def test_quantized_matmul_at_verify_rows(cuda, d, f):
    """M = 40, the verify's rows over 8 slots at k 4: within the matmul's
    tolerance of plain on the ``mma`` body, the same bits on every call
    and from four threads at once (the fleet's case)."""
    x = _randn((40, d), 4, torch.bfloat16)
    w = tqm.quantize_tensor(_randn((d, f), 5, torch.float32))
    assert tqm.kernel_plan(40, d, f, torch.bfloat16, x.device)["path"] == "mma"
    first = tqm.quantized_matmul(x, w)
    ref = tqm.quantized_matmul_plain(x, w)
    assert (first - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    got = [None] * 4

    def work(i):
        got[i] = [tqm.quantized_matmul(x, w) for _ in range(3)]

    pool = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=60)
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for outs in got for o in outs)


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 16, "kv_page_size": 8},
                                {"weights_dtype": "int8"}], ids=["dense", "paged", "int8w"])
def test_speculative_kernel_engine_matches_plain_and_reference(cuda, kw):
    """f32 greedy tokens of the speculative kernel engine (the verify on
    the decode kernel's ``rows`` body at T = 3, the draft on plain
    attention) equal the plain kernel engine's and the speculative
    reference engine's; every verify launched the decode kernel."""
    from mpit_tpu_torch.serve import draft_from_target

    cfg = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
                          d_model=32, dtype=torch.float32)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    dstate, dcfg = draft_from_target(state, cfg, 1)
    prompts = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
    spec = dict(spec_k=2, draft_params=dstate, draft_cfg=dcfg)
    tokens = {}
    for name, mode, extra in (("plain", "kernel", {}), ("spec", "kernel", spec),
                              ("spec_ref", "reference", spec)):
        before = dict(tda.path_launches)
        server = Server(Engine(cfg, state, slots=2, max_len=40, prefill_len=8,
                               decode_attention=mode, **kw, **extra))
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        tokens[name] = {c.rid: c.tokens for c in server.run()}
        if name == "spec":
            rows = sum(n for key, n in _path_delta(before).items() if key.endswith("/rows"))
            assert rows >= cfg.num_layers * server.stats()["ticks"] // 2
    assert tokens["spec"] == tokens["plain"] == tokens["spec_ref"]


# -- tensor-parallel serving: the kernels on a rank's shard -------------------


@pytest.mark.parametrize("heads", [6, 3], ids=["p2", "p4"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [None, 16], ids=["dense", "ps16"])
@pytest.mark.parametrize("t", [1, 5, 64])
def test_decode_kernel_on_a_tp_head_shard(cuda, heads, kv, ps, t):
    """GPT-2 small's head shard at p 2 (6 heads) and p 4 (3 heads), Dh
    64: the decode kernel against its plain version, bf16 q over bf16 or
    int8 K/V, on the body the rule names (split at T 1, mma / q8mma
    above), dense and paged 16."""
    b, s, d = 8, 256, 64
    q = _randn((b, t, heads, d), 11 + t, torch.bfloat16)
    lens = torch.linspace(0, s - t, b, device="cuda").int()
    rows = (b * s // ps + 1, ps) if ps else (b, s)
    k, v = (_randn((*rows, heads, d), 12 + i, torch.bfloat16) for i in range(2))
    if kv == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    before = dict(tda.path_launches)
    if ps:
        bt = torch.randperm(rows[0] - 1, generator=torch.Generator().manual_seed(t))
        bt = bt.reshape(b, s // ps).int().cuda()
        out = tda.flash_paged_decode_attention(q, k, v, lens, bt)
        ref = tda.reference_paged_decode_attention(q, k, v, lens, bt)
    else:
        out = tda.flash_decode_attention(q, k, v, lens)
        ref = tda.reference_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    path = tda._decode_path(torch.bfloat16, torch.int8 if kv == "int8" else torch.bfloat16, t)
    assert list(_path_delta(before)) and all(
        key.endswith("/" + path) for key in _path_delta(before))
    assert (out.float() - ref.float()).abs().max().item() <= 5e-2


# The four dense layers' int8 shards at p 2 and p 4 (K x N): qkv and fc
# column shards, proj and out row shards.
_TP_QMM_SHAPES = [(768, 1152), (768, 1536), (384, 768), (1536, 768),
                  (768, 576), (768, 768), (192, 768), (768, 768)]


@pytest.mark.parametrize("d,f", _TP_QMM_SHAPES)
@pytest.mark.parametrize("m", [8, 40, 512])
def test_quantized_matmul_at_tp_shards(cuda, m, d, f):
    """The int8 matmul on each TP weight shard (N 576 and 1152: not whole
    128-wide prefill tiles; K 192 and 384: new contraction lengths) at
    the decode tick's, the verify's and a prefill chunk's rows: one
    launch on ``mma``, within 1e-4 x max(1, max |plain|)."""
    x = _randn((m, d), 21, torch.bfloat16)
    w = tqm.quantize_tensor(_randn((d, f), 22, torch.float32) / d**0.5)
    paths = dict(tqm.path_launches)
    out = tqm.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert {k: n - paths[k] for k, n in tqm.path_launches.items() if n != paths[k]} == {"mma": 1}
    ref = tqm.quantized_matmul_plain(x, w)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("kw", [{}, {"kv_pages": 16, "kv_page_size": 8},
                                {"weights_dtype": "int8"}, {"kv_dtype": "int8"}],
                         ids=["dense", "paged", "int8w", "int8kv"])
def test_tp_engine_on_the_card_matches_one_rank(cuda, p, kw):
    """A tiny f32 TP engine (4 heads of 16, p ranks on the card): greedy
    tokens equal the one-rank kernel engine's; the decode kernel launches
    once a rank a layer a call, on H/p heads, and (int8 weights) the
    matmul once a rank for each of the four dense layers."""
    from mpit_tpu_torch import comm

    cfg = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=4,
                          d_model=64, dtype=torch.float32)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    prompts = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
    tokens, launches = {}, {}
    for ranks in (0, p):
        tp = dict(world=comm.init({"model": ranks}, devices=["cuda"]), tp_axis="model") \
            if ranks else {}
        for mod in (tda, tqm):
            mod.launches.update(dict.fromkeys(mod.launches, 0))
        server = Server(Engine(cfg, state, slots=2, max_len=40, prefill_len=8, **kw, **tp))
        for i, pr in enumerate(prompts):
            server.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        tokens[ranks] = {c.rid: c.tokens for c in server.run()}
        launches[ranks] = (sum(tda.launches.values()), tqm.launches["quantized_matmul"])
    assert tokens[p] == tokens[0]
    attn, mm = launches[p]
    assert attn == p * launches[0][0]
    assert mm == (p * launches[0][1] if "weights_dtype" in kw else 0)


def _host_tier_engine(kw):
    from mpit_tpu_torch import comm

    cfg = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=4,
                          d_model=64, dtype=torch.float32)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    kw = dict(kw)
    if kw.pop("tp", 0):
        kw.update(world=comm.init({"model": 2}, devices=["cuda"]), tp_axis="model")
    return Engine(cfg, state, slots=2, max_len=64, prefill_len=32, kv_pages=10,
                  kv_page_size=8, prefill_chunk=8, kv_host_pages=8, **kw)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "bf16"}, {"kv_dtype": "int8"}, {"tp": 2}],
                         ids=["f32", "bf16", "int8", "tp2"])
def test_host_tier_restores_spilled_page_bit_equal(cuda, kw):
    """A page spilled to its pinned seat, overwritten on the card, then
    restored: every tensor it spans (rows, scales, every rank's heads)
    is back bit for bit."""
    engine = _host_tier_engine(kw)
    assert all(seat.is_pinned() for seat in engine._host_seats)
    server = Server(engine)
    server.submit(Request(rid=0, prompt=list(range(1, 19)), max_new_tokens=20))
    server.run(max_ticks=4)
    page = int(engine.allocator.block_tables[0, 1])
    before = [v.clone() for v in engine._page_views(page)]
    engine.spill_page(page, 5)
    for v in engine._page_views(page):
        v.fill_(3)
    assert engine.drain_spills() == 1
    engine.restore_page(5, page, release=True)
    assert all(torch.equal(a, b) for a, b in zip(engine._page_views(page), before))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_host_tier_spill_survives_the_next_prefill_rewriting_its_page(cuda, kv_dtype):
    """A victim is parked and, before any drain, a new request is admitted
    into the pages it freed and prefilled (its rows written over the
    spilled pages). The seats hold the victim's rows as they were, and
    the victim resumes from them and completes."""
    from mpit_tpu_torch.serve import SchedulingPolicy

    engine = _host_tier_engine({"kv_dtype": kv_dtype})
    server = Server(engine, policy=SchedulingPolicy())
    server.submit(Request(rid="v", prompt=list(range(3, 23)), max_new_tokens=20, priority=1))
    server.run(max_ticks=6)
    slot = next(iter(server.live))
    fill = server.live[slot].cache_fill()
    pages = [int(p) for p in engine.allocator.block_tables[slot, : -(-fill // 8)]]
    before = [[v.clone() for v in engine._page_views(p)] for p in pages]
    server._preempt(slot)
    seats = engine.allocator.peek_parked("v").host_pages
    server.submit(Request(rid="b", prompt=list(range(40, 64)), max_new_tokens=4))
    server._admit()
    server._prefill_chunk_tick()  # b's first chunk, before the tick's drain
    b_slot = next(iter(server.prefilling), None) or next(iter(server.live))
    assert set(pages) & set(int(p) for p in engine.allocator.block_tables[b_slot, :3])
    engine.drain_spills()
    for hp, views in zip(seats, before):
        assert all(torch.equal(seat[hp], v.cpu()) for seat, v in zip(engine._host_seats, views))
    done = {c.rid: c.tokens for c in server.run()}
    assert len(done["v"]) == 20 and len(done["b"]) == 4
    assert len(server.resume_durations["restream"]) == 1


# -- observability on the card ----------------------------------------------


def _obs_engine(kw):
    cfg = GPT2Config.tiny(vocab_size=64, max_seq_len=128, num_layers=2, num_heads=4,
                          d_model=64, dtype=torch.bfloat16)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    return cfg, Engine(cfg, state, slots=3, max_len=128, prefill_len=64, **kw)


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 40, "kv_page_size": 16, "prefill_chunk": 16},
                                {"kv_dtype": "int8"}], ids=["dense", "paged", "dense_int8"])
def test_modeled_visited_tiles_equal_the_kernels(cuda, kw):
    """After a few ticks, the decode kernel over the engine's cache at the
    live fills (free slots at 0) reports the tiles the engine's roofline
    model counts, bit for bit."""
    from mpit_tpu_torch.obs import roofline

    cfg, engine = _obs_engine(kw)
    server = Server(engine)
    for rid, (n, new) in enumerate(((5, 30), (40, 20))):
        server.submit(Request(rid=rid, prompt=list(range(1, n + 1)), max_new_tokens=new))
    server.run(max_ticks=6)
    fills = np.zeros(engine.slots, np.int32)
    for slot, live in server.live.items():
        fills[slot] = live.cache_fill()
    live = fills[sorted(server.live)]
    q = torch.randn((engine.slots, 1, cfg.num_heads, cfg.head_dim), device="cuda").bfloat16()
    c = engine.cache
    lens = torch.tensor(fills, device="cuda")
    if engine.paged:
        _, vis = tda.flash_paged_decode_attention(
            q, c.k[0], c.v[0], lens, engine._block_tables(), block_k=engine.decode_block_k,
            return_visited=True)
    else:
        k0 = c.k[0] if not hasattr(c.k, "q") else type(c.k)(q=c.k.q[0], scale=c.k.scale[0])
        v0 = c.v[0] if not hasattr(c.v, "q") else type(c.v)(q=c.v.q[0], scale=c.v.scale[0])
        _, vis = tda.flash_decode_attention(q, k0, v0, lens, block_k=engine.decode_block_k,
                                            return_visited=True)
    vis = vis.cpu().numpy()
    assert np.array_equal(vis, tda.num_kv_blocks(fills, 1, engine.max_len, engine.decode_block_k))
    assert engine.decode_achieved_hbm_bytes(live) == roofline.decode_step_hbm_bytes(
        int(vis.sum()), block_k=engine.decode_block_k, kv_row_bytes=engine._kv_row_bytes,
        num_layers=cfg.num_layers, param_bytes=engine._param_bytes, appended_rows=len(live))


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 40, "kv_page_size": 16, "kv_dtype": "int8"},
                                {"weights_dtype": "int8"}],
                         ids=["dense", "paged_int8_kv", "int8_weights"])
def test_ledger_reconciles_with_memory_allocated(cuda, kw):
    """The engine's ledger against ``torch.cuda.memory_allocated`` less what
    the process held before the engine, during and after a served run: a
    four-layer GPT-2 at small's width (about 130 MB of bf16 weights),
    cuBLAS's workspace made first (the process's, not the engine's)."""
    import gc

    gc.collect()
    for dt in (torch.float32, torch.bfloat16):
        torch.ones((8, 8), dtype=dt, device="cuda") @ torch.ones((8, 8), dtype=dt, device="cuda")
    cfg = GPT2Config.small(num_layers=4)
    state = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    engine = Engine(cfg, state, slots=3, max_len=128, prefill_len=64, **kw)
    server = Server(engine)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=list(range(1, 9 + rid)), max_new_tokens=12))
    server.run(max_ticks=5)
    rec = server.stats()["memory"]["reconciliation"]
    assert rec["device_bytes"] is not None and rec["within_tolerance"], rec
    server.run()
    mem = server.stats()["memory"]
    assert mem["conservation"]["ok"] and mem["reconciliation"]["within_tolerance"]


def test_profile_dir_traces_the_flash_kernels(cuda, tmp_path):
    """``gpt2 --profile-dir`` on the card: the profiler's Chrome trace holds
    the flash kernels' device events; the step's roofline carries shares."""
    from mpit_tpu_torch.asyncsgd.gpt2 import main
    from mpit_tpu_torch.utils.profiling import device_events

    out = main(["--steps", "7", "--vocab-size", "128", "--seq-len", "64", "--num-layers", "2",
                "--num-heads", "2", "--d-model", "128", "--flash", "true", "--log-every", "1",
                "--sentinel", "true", "--profile-dir", str(tmp_path)])
    names = [e["name"] for e in device_events(out["profile"]["path"])]
    for kernel in ("fwd_kernel", "dq_kernel", "dkv_kernel"):
        assert any(kernel in n for n in names), kernel
    step = out["roofline"]["phases"]["step"]
    # Steps 0 (set-up) and 2..6 (the window and the export) are left out.
    assert step["platform"] == "cuda" and step["executions"] == 1
    assert {"mfu_pct", "hbm_util_pct"} <= set(step) and step["hbm_util_pct"] <= 100
    assert step["achieved_flops"] > 0 and step["seconds"] > 0
    assert out["sentinel"]["metrics"]["step"]["count"] == 7


# ---- the pjit and context-parallel tiers over the flash kernels -------------


def _tier_cfg():
    return GPT2Config.tiny(vocab_size=130, max_seq_len=64, num_layers=2, num_heads=4,
                           d_model=64, dtype=torch.float32)


@pytest.mark.parametrize("mesh,fsdp", [({"data": 2, "model": 2}, None),
                                       ({"data": 2, "model": 2}, "data"), ({"model": 4}, None)],
                         ids=["tp", "tp_fsdp", "model4"])
def test_tp_flash_step_matches_plain(cuda, mesh, fsdp):
    """Three goo_adam steps of the pjit tier (a vocabulary of 130, padded
    per rank) on the card through the flash kernels, on each rank's H/m
    heads, against the same tier through plain attention: losses within
    1e-4 relative; each kernel ran layers x model ranks x data ranks x
    steps times, all on the f32 body."""
    import dataclasses

    from mpit_tpu_torch import comm
    from mpit_tpu_torch.models import default_attention
    from mpit_tpu_torch.ops import flash_attention as tfa
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.parallel.tp import gpt2_tp_rules, make_tp_train_step
    from mpit_tpu_torch.serve.tp import TPGPT2
    from mpit_tpu_torch.serve.weights import shard_gpt2_params

    cfg = _tier_cfg()
    init = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    tokens = torch.randint(0, 130, (3, 4, 65), generator=torch.Generator().manual_seed(1)).cuda()
    world = comm.init(mesh, devices=["cuda"])
    m, d = world.size("model"), world.size("data")
    losses, ran = {}, {}
    for label, attn in (("flash", tfa.flash_attention), ("plain", default_attention)):
        model = TPGPT2(dataclasses.replace(cfg, attention_fn=attn), m, device="cuda",
                       vocab_parallel=True)
        model.load_state_dict(shard_gpt2_params(init, m, vocab_parallel=True))

        def loss_fn(params, batch, model=model):
            t = batch["tokens"]
            return model(t[:, :-1], targets=t[:, 1:]).mean(), {}

        init_fn, step_fn, _ = make_tp_train_step(loss_fn, goo_adam(1e-3), world,
                                                 gpt2_tp_rules(), fsdp_axis=fsdp)
        state = init_fn(dict(model.named_parameters()))
        before = dict(tfa.path_launches)
        losses[label] = []
        for t in tokens:
            state, metrics = step_fn(state, {"tokens": t})
            losses[label].append(metrics["loss"].item())
        ran[label] = {k: n - before[k] for k, n in tfa.path_launches.items() if n != before[k]}
    want = cfg.num_layers * m * d * len(tokens)
    assert ran["flash"] == {f"{k}/fma": want for k in ("fwd", "dq", "dkv")}
    assert ran["plain"] == {}
    np.testing.assert_allclose(losses["flash"], losses["plain"], rtol=1e-4)


@pytest.mark.parametrize("s", [2, 4])
def test_ring_flash_block_chain_matches_plain(cuda, s):
    """The ring of flash blocks on the card (each step one launch over the
    ranks it reaches, at offsets (s·T/S, 0)) against the same chain of
    the plain versions on the CPU: f32 output and gradients within 1e-4;
    S launches of each kernel a call, one a ring step (step ``st`` over
    the ``(S - st)·B`` rows at offsets ``(st·T/S, 0)``), none for the
    wholly-future blocks."""
    from mpit_tpu_torch.ops import flash_attention as tfa
    from mpit_tpu_torch.parallel.ring_attention import ring_flash_attention

    out = {}
    for dev in ("cuda", "cpu"):
        q, k, v, w = (_randn((s, 2, 128, 3, 64), i, torch.float32).to(dev) for i in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before, by_shape = dict(tfa.launches), tfa.shape_launches.copy()
        o = ring_flash_attention(q, k, v)
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out[dev] = (o.detach().cpu(), *(g.cpu() for g in grads))
        if dev == "cuda":
            assert {n: tfa.launches[n] - before[n] for n in before} == dict.fromkeys(before, s)
            assert tfa.shape_launches - by_shape == {
                (kind, (s - st) * 2, 128, 3, st * 128, 0): 1
                for kind in ("fwd", "dq", "dkv") for st in range(s)}
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh,ulysses", [({"data": 2, "seq": 2}, False),
                                          ({"data": 2, "seq": 2}, True)],
                         ids=["ring_flash", "ulysses_flash"])
def test_cp_flash_step_on_the_card_matches_the_cpu(cuda, mesh, ulysses):
    """Three steps of the CP tier on the card through the flash kernels
    against the same step on the CPU (the kernels' plain versions):
    losses within 1e-4 relative."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.parallel.cp import make_gpt2_cp_train_step

    cfg = _tier_cfg()
    init = GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    tokens = torch.randint(0, 130, (3, 4, 64), generator=torch.Generator().manual_seed(2))
    losses = {}
    for dev in ("cuda", "cpu"):
        world = comm.init(mesh, devices=[dev])
        init_fn, step_fn, _ = make_gpt2_cp_train_step(cfg, goo_adam(1e-3), world, flash=True,
                                                      ulysses=ulysses)
        state = init_fn(init)
        losses[dev] = []
        for t in tokens:
            state, metrics = step_fn(state, {"tokens": t.to(dev)})
            losses[dev].append(metrics["loss"].item())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
