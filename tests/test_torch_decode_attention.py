"""mpit_tpu_torch flash-decode attention against the JAX package.

On the CPU the port's wrapper runs its plain version; it must agree with
the JAX ``flash_decode_attention`` (its reference path, which
``tests/test_decode_attention.py`` pins to the Pallas kernel in
interpret mode; one tiny case here runs that kernel directly) within the
JAX kernel tests' own f32 tolerance, 2e-5. The tile-bound helpers must
be equal, not close. The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``, on a GPU.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import decode_attention as jda
from mpit_tpu.ops import kv_quant as jkq
from mpit_tpu_torch.ops import decode_attention as tda
from mpit_tpu_torch.ops import kv_quant as tkq

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, t, h, s, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d))
    )
    return q, k, v, np.asarray(lengths, np.int32)


def _both(q, k, v, lengths, **jax_kw):
    j_out, j_vis = jda.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        return_visited=True, **jax_kw,
    )
    t_out, t_vis = tda.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), return_visited=True,
    )
    return (np.asarray(j_out), np.asarray(j_vis)), (t_out.numpy(), t_vis.numpy())


@pytest.mark.parametrize("t,h", [(1, 3), (1, 4), (5, 3), (5, 4)])
def test_plain_matches_jax(t, h):
    """Ragged lengths from 0 to S - T, decode (T=1) and small-T
    prefill (T=5), odd and even head counts."""
    s = 32
    lengths = [0, 1, 9, s - t - 1, s - t]
    (j_out, j_vis), (t_out, t_vis) = _both(*_inputs(5, t, h, s, 16, lengths))
    np.testing.assert_allclose(t_out, j_out, **TOL)
    np.testing.assert_array_equal(t_vis, j_vis)


def test_plain_matches_jax_kernel_interpret():
    """The one case that runs the JAX package's Pallas kernel itself,
    through the interpreter, at a tiny size."""
    (j_out, j_vis), (t_out, t_vis) = _both(
        *_inputs(2, 2, 2, 16, 16, [0, 14], seed=1), interpret=True
    )
    np.testing.assert_allclose(t_out, j_out, **TOL)
    np.testing.assert_array_equal(t_vis, j_vis)


def test_block_k_and_num_kv_blocks_match_jax():
    for s in (8, 16, 24, 32, 48, 64, 96, 128, 200, 512, 1000, 1024):
        for want in (None, 8, 16, 64, 2048):
            bk = tda.pick_block_k(s, want)
            assert bk == jda.pick_block_k(s, want), (s, want)
            if s % bk:
                continue
            for t in (1, 3, 8):
                lens = np.arange(0, max(s - t, 0) + 1, dtype=np.int32)
                np.testing.assert_array_equal(
                    tda.num_kv_blocks(lens, t, s, bk),
                    jda.num_kv_blocks(lens, t, s, bk),
                )
                np.testing.assert_array_equal(
                    tda.num_kv_blocks(torch.from_numpy(lens), t, s, bk).numpy(),
                    jda.num_kv_blocks(lens, t, s, bk),
                )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, lens = (
        torch.from_numpy(x) for x in _inputs(2, 1, 2, 24, 16, [0, 3])
    )
    with pytest.raises(ValueError, match="divisible"):
        tda.flash_decode_attention(q, k, v, lens, block_k=16)
    bad = [
        (q.half(), k.half(), v.half(), lens, "dtype"),
        (q, k.to(torch.bfloat16), v, lens, "share one dtype"),
        (q, k.transpose(0, 1).contiguous().transpose(0, 1), v, lens, "contiguous"),
        (q, k, v, lens.long(), "int32"),
        (q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous(), lens, "shape"),
        (q[..., :12].contiguous(), k[..., :12].contiguous(),
         v[..., :12].contiguous(), lens, "head dim"),
    ]
    for bq, bk_, bv, bl, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tda._check_kernel_inputs(bq, bk_, bv, bl)


def test_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes
    to the kernel or raises."""
    q = torch.empty((1, 1, 2, 16), device="meta")
    k = torch.empty((1, 16, 2, 16), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no flash-decode kernel"):
        tda.flash_decode_attention(q, k, k, lens)


# What the kernel's redesign decides on the host: which body runs, what
# shared memory each body takes, and the split body's merge rule.

_KV = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("t", [1, 2, 64, 128])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("q", ["f32", "bf16"])
def test_decode_path_rule(q, kv, t):
    """bf16 q at T > 1 takes a tensor-core body, ``mma`` over bf16 K/V and
    ``q8mma`` over int8 K/V; every T = 1 call the split body; the rest
    (an f32 operand at T > 1) the rows body."""
    tensor_core = {("bf16", "bf16"): "mma", ("bf16", "int8"): "q8mma"}
    want = "split" if t == 1 else tensor_core.get((q, kv), "rows")
    assert tda._decode_path(_KV[q], _KV[kv], t) == want


@pytest.mark.parametrize("path", ["split", "mma", "q8mma", "rows"])
def test_smem_bytes_fit_and_oversized_rows_are_refused(path):
    """Every body fits a Hopper block at GPT-2 small's head dim and the
    widest block-table row of the serving pools (max_len 512 over pages
    of 16: 32 pages), for each K/V dtype it takes; a block-table row too
    long for the body's shared memory is refused before any launch."""
    kvs = {"mma": [torch.bfloat16], "q8mma": [torch.int8]}.get(path, list(_KV.values()))
    for kv in kvs:
        for d in (16, 32, 64, 128):
            assert tda._smem_bytes(path, d, 0, kv) < tda._smem_bytes(path, d, 32, kv)
        assert tda._smem_bytes(path, 64, 32, kv) <= tda._MAX_SMEM
    t = 1 if path == "split" else 2
    q = torch.zeros((1, t, 2, 64), dtype=torch.float32 if path == "rows" else torch.bfloat16)
    pool = torch.zeros((4, 16, 2, 64), dtype=q.dtype)
    if path == "q8mma":
        pool = tkq.quantize_kv(pool.float())
    assert tda._decode_path(q.dtype, pool.dtype, t) == path
    lens = torch.zeros((1,), dtype=torch.int32)
    fits = torch.zeros((1, 32), dtype=torch.int32)
    tda._check_kernel_inputs(q, pool, pool, lens, fits)
    pages = tda._MAX_SMEM // 4  # more entries than the whole block holds
    with pytest.raises(ValueError, match=f"shared memory on the {path} body"):
        tda._check_kernel_inputs(q, pool, pool, lens, torch.zeros((1, pages), dtype=torch.int32))


def test_split_merge_rule_matches_reference():
    """The split body's arithmetic on the plain path: each of the W warps
    attends its interleaved 32-key chunks (``reference_attention_with_lse``
    over the visible keys it holds; a warp holding none gives o = 0, lse
    = -1e30), and ``merge_attention`` folds the partials in warp order.
    The result is ``reference_decode_attention`` within 1e-6 (f32),
    including a slot of length 0, where every warp but the first is
    empty."""
    from mpit_tpu_torch.ops.flash_attention import merge_attention, reference_attention_with_lse

    s, w, kc = 256, tda._SPLIT_WARPS, tda._KC
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(4, 1, 3, s, 16, [0, 5, 100, s - 1], seed=3))
    outs = []
    for b, length in enumerate(lens.tolist()):
        o = lse = None
        for warp in range(w):
            keys = [j for j in range(length + 1) if (j // kc) % w == warp]
            if keys:
                part = reference_attention_with_lse(
                    q[b : b + 1], k[b : b + 1, keys], v[b : b + 1, keys], causal=False
                )
            else:  # one key in the queries' future: o = 0, lse = -1e30
                part = reference_attention_with_lse(
                    q[b : b + 1], k[b : b + 1, :1], v[b : b + 1, :1], k_offset=1
                )
                assert (part[0] == 0).all() and (part[1] == -1e30).all()
            o, lse = part if o is None else merge_attention(o, lse, *part)
        outs.append(o)
    want = tda.reference_decode_attention(q, k, v, lens)
    np.testing.assert_allclose(torch.cat(outs).numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_bf16_ragged_tile_at_the_slot_end_matches_jax():
    """A boundary of the tensor-core body: bf16 inputs, T = 65 (one whole
    64-row tile and one of a single row) and a slot filled to S - T.
    JAX's reference path (its CPU tests' own) and the port's plain
    version agree within 2e-2: both take bf16 operands to f32 scores and
    round the output to bf16, so they may part by one bf16 step (1/64
    for outputs in [2, 4), the largest here) where sums in another order
    land on either side of a rounding boundary."""
    t, s = 65, 128
    q, k, v, lens = _inputs(3, t, 2, s, 16, [0, 17, s - t], seed=4)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    j_out, j_vis = jda.flash_decode_attention(bf(q), bf(k), bf(v), jnp.asarray(lens), return_visited=True)
    tb = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    t_out, t_vis = tda.flash_decode_attention(tb(q), tb(k), tb(v), torch.from_numpy(lens), return_visited=True)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out.astype(jnp.float32)), rtol=0, atol=2e-2
    )
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))


def _q8mma_model(q, k, v, lengths, pieces=3):
    """The q8mma body's arithmetic in plain PyTorch, ``[B, T, H, D]``
    bf16 q against dense QuantizedKV ``[B, S, H, D]``: f32 scores from
    the int8 rows as bf16 (exact, and so are their products with bf16
    q), the K scale and then 1/sqrt(D) on the f32 score, masked keys at
    weight 0, l summed from the unrounded p, w = p * v_scale split into
    bf16 hi, mid, lo, each piece a product against the int8 V rows as
    bf16, o = acc / l. Returns o in f32, before its cast to bf16, and the
    pieces with w. ``pieces=1`` models the body with hi alone."""
    b, t, h, d = q.shape
    kq, vq = k.q.bfloat16().float(), v.q.bfloat16().float()
    ks, vs = (x.scale[..., 0].permute(0, 2, 1)[:, :, None, :] for x in (k, v))  # [B, H, 1, S]
    s = torch.einsum("bthd,bshd->bhts", q.float(), kq) * ks * (1.0 / math.sqrt(d))
    q_pos = lengths.long()[:, None] + torch.arange(t)
    vis = torch.arange(k.shape[1])[None, None, :] <= q_pos[:, :, None]  # [B, T, S]
    s = torch.where(vis[:, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    w = p * vs
    hi = w.bfloat16()
    mid = (w - hi.float()).bfloat16()
    lo = (w - hi.float() - mid.float()).bfloat16()
    acc = sum(torch.einsum("bhts,bshd->bthd", x.float(), vq) for x in (hi, mid, lo)[:pieces])
    return acc / l.permute(0, 2, 1)[..., None], (w, hi, mid, lo)


def test_q8mma_arithmetic_matches_jax_int8_decode():
    """The int8 tensor-core body's arithmetic (``_q8mma_model``) against
    the JAX package's int8 decode on the CPU (its reference path, as
    ``_both`` runs it) and the port's plain version, at a ragged T = 65
    (one whole 64-row tile and a one-row tile), lengths 0 to S - T.

    - hi + mid + lo is w to within 2^-24 |w|: three bf16 products carry
      p in f32 precision, as the JAX kernel's f32 p against f32
      (dequantized) V does;
    - so the model's f32 output equals JAX's int8 decode with q taken to
      f32 (every operand f32: the JAX kernel's arithmetic for a bf16 q)
      within the file's f32 tolerance, 2e-5 (f32 sums in other orders);
    - its bf16 output equals JAX's and the port's plain int8 decode with
      the bf16 q within 2e-2: those round each normalized p to bf16
      (p.astype(q.dtype)) and the model rounds o once to bf16, each a
      relative 2^-9 at most, under 0.009 for the |v| < 4.5 here."""
    t, s, h, d = 65, 128, 2, 16
    q, k, v, lens = _inputs(3, t, h, s, d, [0, 17, s - t], seed=5)
    q = q.astype(jnp.bfloat16).astype(np.float32)  # bf16 values
    jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
    tk, tv = tkq.quantize_kv(torch.from_numpy(k)), tkq.quantize_kv(torch.from_numpy(v))
    tq, tl = torch.from_numpy(q).bfloat16(), torch.from_numpy(lens)
    assert tda._decode_path(tq.dtype, tk.dtype, t) == "q8mma"
    o32, (w, hi, mid, lo) = _q8mma_model(tq, tk, tv, tl)
    split = hi.float() + mid.float() + lo.float()
    assert ((split - w).abs() <= 2.0**-24 * w.abs()).all()

    want32 = jda.flash_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(o32.numpy(), np.asarray(want32), **TOL)

    o = o32.bfloat16().float().numpy()
    want = jda.flash_decode_attention(jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(lens))
    plain = tda.flash_decode_attention(tq, tk, tv, tl)
    np.testing.assert_array_equal(tv.q.numpy(), np.asarray(jv.q))  # the same bytes
    assert float(tkq.dequantize_kv(tv).abs().max()) < 4.5
    np.testing.assert_allclose(o, np.asarray(want.astype(jnp.float32)), rtol=0, atol=2e-2)
    np.testing.assert_allclose(o, plain.float().numpy(), rtol=0, atol=2e-2)


def _exact_share(out, ref32):
    """Share of bf16 ``out``'s elements equal to the f32 ``ref32``
    rounded once to bf16, and ``out``'s largest error against ``ref32``
    in units of 2^-8 max |ref32| (one bf16 step at the largest output)."""
    got = out.float()
    share = (got == ref32.bfloat16().float()).float().mean().item()
    step = 2.0**-8 * ref32.abs().max().item()
    return share, (got - ref32).abs().max().item() / step


@pytest.mark.parametrize("d", [16, 64])
def test_q8mma_split_is_what_keeps_p_in_f32(d):
    """The limit ``tests/test_torch_cuda.py`` holds the q8mma kernel to
    (its bf16 output against the f32-p reference, the plain int8 decode
    with q taken to f32, rounded once to bf16: within one bf16 step at the
    largest output and equal in at least 99% of the elements) separates
    the body's three-piece split from hi alone. The modelled body with
    hi, mid and lo meets it (f32 sums in another order flip a rounding
    only next to a tie); with hi alone, which rounds w = p * v_scale to
    bf16, fewer than 70% of the elements match; the plain int8 decode
    with the bf16 q, which rounds p to bf16, matches in fewer than 5%."""
    t, s, h = 65, 128, 2
    q, k, v, lens = _inputs(3, t, h, s, d, [0, 17, s - t], seed=6)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = tkq.quantize_kv(torch.from_numpy(k)), tkq.quantize_kv(torch.from_numpy(v))
    tl = torch.from_numpy(lens)
    ref32 = tda.reference_decode_attention(tq.float(), tk, tv, tl)
    share, err = _exact_share(_q8mma_model(tq, tk, tv, tl)[0].bfloat16(), ref32)
    assert share >= 0.99 and err <= 1.0, (share, err)
    share, _ = _exact_share(_q8mma_model(tq, tk, tv, tl, pieces=1)[0].bfloat16(), ref32)
    assert share < 0.7, share
    share, _ = _exact_share(tda.flash_decode_attention(tq, tk, tv, tl), ref32)
    assert share < 0.05, share
