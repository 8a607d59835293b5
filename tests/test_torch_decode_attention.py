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
