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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import decode_attention as jda
from mpit_tpu_torch.ops import decode_attention as tda

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
    """bf16 q and K/V at T > 1 take the tensor-core body, every T = 1
    call the split body, the rest the rows body."""
    want = "split" if t == 1 else "mma" if (q, kv) == ("bf16", "bf16") else "rows"
    assert tda._decode_path(_KV[q], _KV[kv], t) == want


@pytest.mark.parametrize("path", ["split", "mma", "rows"])
def test_smem_bytes_fit_and_oversized_rows_are_refused(path):
    """Every body fits a Hopper block at GPT-2 small's head dim and the
    widest block-table row of the serving pools (max_len 512 over pages
    of 16: 32 pages), for each K/V dtype it takes; a block-table row too
    long for the body's shared memory is refused before any launch."""
    kvs = [torch.bfloat16] if path == "mma" else list(_KV.values())
    for kv in kvs:
        for d in (16, 32, 64, 128):
            assert tda._smem_bytes(path, d, 0, kv) < tda._smem_bytes(path, d, 32, kv)
        assert tda._smem_bytes(path, 64, 32, kv) <= tda._MAX_SMEM
    t = 1 if path == "split" else 2
    q = torch.zeros((1, t, 2, 64), dtype=torch.float32 if path == "rows" else torch.bfloat16)
    pool = torch.zeros((4, 16, 2, 64), dtype=q.dtype)
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
