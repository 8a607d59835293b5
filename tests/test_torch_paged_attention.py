"""mpit_tpu_torch's paged cache path and int8 KV against the JAX package's.

Inputs are made by numpy from a seed and go through both packages.

- ``paged_cache_update`` and ``paged_gather`` are exact, dropped rows
  included: the port's pool carries one trash page past the P pages the
  JAX pool has, and its first P pages must equal JAX's bit for bit;
- ``paged_cached_attention`` and the plain ``flash_paged_decode_attention``
  agree with JAX's reference within the JAX kernel tests' own f32
  tolerance, 2e-5, and one tiny case runs JAX's Pallas paged kernel in
  interpret mode; ``visited`` equals ``num_kv_blocks`` over the virtual
  capacity;
- int8: ``quantize_blocks``/``quantize_kv`` payloads and scales are
  bit-identical to JAX's (ties included); the quantized attention, dense
  and paged, agrees within 2e-5 (both dequantize the same bytes to f32
  and sum in f32, in different orders);
- the model: a paged prefill chunk and decode ticks through ``GPT2``,
  f32 and int8 pools, hiddens within 1e-4 of JAX's (the tolerance of
  ``tests/test_torch_gpt2.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import gpt2 as jgpt2
from mpit_tpu.ops import decode_attention as jda
from mpit_tpu.ops import kv_quant as jkq
from mpit_tpu.ops import ring_collectives as jrc
from mpit_tpu.serve import kvcache as jkv
from mpit_tpu_torch.models import gpt2 as tgpt2
from mpit_tpu_torch.ops import decode_attention as tda
from mpit_tpu_torch.ops import kv_quant as tkq
from mpit_tpu_torch.ops import ring_collectives as trc
from mpit_tpu_torch.serve import kvcache as tkv
from mpit_tpu_torch.serve import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _table(b, n_ps, num_pages, seed):
    """Block tables naming a seeded permutation of the pool's pages,
    slot 1 sharing slot 0's first two pages."""
    perm = np.random.default_rng(seed).permutation(num_pages)[: b * n_ps]
    bt = perm.reshape(b, n_ps).astype(np.int32)
    bt[1, :2] = bt[0, :2]
    return bt


def _parts(buf):
    """A K/V buffer's tensors, JAX's or the port's: itself, or the int8
    payload and its scales."""
    return (buf.q, buf.scale) if hasattr(buf, "scale") else (buf,)


def _torch_pool(pool_np):
    """The port's pool: JAX's pages plus the trash page."""
    trash = np.zeros((1,) + pool_np.shape[1:], pool_np.dtype)
    return torch.from_numpy(np.concatenate([pool_np, trash]))


# -- writes and gathers ------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_cache_update_exact_with_dropped_rows(quantized):
    """Rows masked by ``valid`` and rows past a slot's virtual capacity
    are dropped by JAX and land in the port's trash page; everything
    else is bit-identical, scales included."""
    b, t, h, d, ps, n_ps, p = 3, 6, 2, 16, 4, 3, 12
    bt = _table(b, n_ps, p, seed=1)
    lengths = np.asarray([0, 5, 9], np.int32)  # slot 2 runs past 12 rows
    valid = np.random.default_rng(2).random((b, t)) > 0.3
    new = _rand((b, t, h, d), 3)
    pool = _rand((p, ps, h, d), 4)
    if quantized:
        jpool = jkq.quantize_kv(jnp.asarray(pool))
        tpool = tkq.QuantizedKV(
            q=_torch_pool(np.asarray(jpool.q)), scale=_torch_pool(np.asarray(jpool.scale))
        )
    else:
        jpool, tpool = jnp.asarray(pool), _torch_pool(pool)
    want = jgpt2.paged_cache_update(
        jpool, jnp.asarray(new), jnp.asarray(lengths), jnp.asarray(bt),
        valid=jnp.asarray(valid),
    )
    got = tgpt2.paged_cache_update(
        tpool, torch.from_numpy(new), torch.from_numpy(lengths),
        torch.from_numpy(bt), valid=torch.from_numpy(valid),
    )
    assert got is tpool  # in place
    for w, g in zip(_parts(want), _parts(got)):
        np.testing.assert_array_equal(g[:p].numpy(), np.asarray(w))
    # The writes really happened, and masked rows really were dropped.
    assert not np.array_equal(_parts(got)[0][:p].numpy(), np.asarray(_parts(jpool)[0]))


def test_paged_gather_exact():
    p, ps, h, d = 10, 4, 2, 16
    pool = _rand((p, ps, h, d), 5)
    bt = _table(2, 3, p, seed=6)
    want = jgpt2.paged_gather(jnp.asarray(pool), jnp.asarray(bt))
    got = tgpt2.paged_gather(_torch_pool(pool), torch.from_numpy(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- attention ---------------------------------------------------------------


def _paged_case(b, t, h, d, ps, n_ps, lengths, seed=0):
    p = b * n_ps + 2
    q = _rand((b, t, h, d), seed)
    k, v = _rand((p, ps, h, d), seed + 1), _rand((p, ps, h, d), seed + 2)
    return q, k, v, np.asarray(lengths, np.int32), _table(b, n_ps, p, seed + 3)


@pytest.mark.parametrize("t", [1, 5])
def test_paged_cached_attention_matches_jax(t):
    q, k, v, lengths, bt = _paged_case(4, t, 3, 16, 4, 6, [0, 3, 11, 24 - t])
    want = jgpt2.paged_cached_attention(*map(jnp.asarray, (q, k, v, lengths, bt)))
    got = tgpt2.paged_cached_attention(
        torch.from_numpy(q), _torch_pool(k), _torch_pool(v),
        torch.from_numpy(lengths), torch.from_numpy(bt),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,ps", [(1, 4), (1, 16), (5, 8)])
def test_plain_paged_flash_matches_jax(t, ps):
    """Ragged lengths, page sizes below and above the kernel's 32-key
    chunk; ``visited`` equals JAX's ``num_kv_blocks`` count."""
    n_ps = 64 // ps
    q, k, v, lengths, bt = _paged_case(4, t, 2, 16, ps, n_ps, [0, 7, 33, 64 - t])
    j_out, j_vis = jda.flash_paged_decode_attention(
        *map(jnp.asarray, (q, k, v, lengths, bt)), return_visited=True
    )
    t_out, t_vis = tda.flash_paged_decode_attention(
        torch.from_numpy(q), _torch_pool(k), _torch_pool(v),
        torch.from_numpy(lengths), torch.from_numpy(bt), return_visited=True,
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))
    bk = tda.pick_block_k(ps)
    np.testing.assert_array_equal(
        t_vis.numpy(), jda.num_kv_blocks(lengths, t, n_ps * ps, bk)
    )


def test_plain_paged_flash_matches_jax_kernel_interpret():
    """The one case that runs the JAX package's Pallas paged kernel
    itself, through the interpreter, at a tiny size."""
    q, k, v, lengths, bt = _paged_case(2, 1, 2, 16, 8, 2, [0, 12], seed=9)
    j_out, j_vis = jda.flash_paged_decode_attention(
        *map(jnp.asarray, (q, k, v, lengths, bt)), interpret=True,
        return_visited=True,
    )
    t_out, t_vis = tda.flash_paged_decode_attention(
        torch.from_numpy(q), _torch_pool(k), _torch_pool(v),
        torch.from_numpy(lengths), torch.from_numpy(bt), return_visited=True,
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))


def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, lengths, bt = (
        torch.from_numpy(x) for x in _paged_case(2, 1, 2, 16, 8, 2, [0, 3])
    )
    with pytest.raises(ValueError, match="divisible"):
        tda.flash_paged_decode_attention(q, k, v, lengths, bt, block_k=3)
    bad = [
        (bt.long(), lengths, "int32"),
        (bt[:1].contiguous(), lengths, "shape"),
        (bt.t().contiguous().t(), lengths, "contiguous"),
    ]
    for bbt, bl, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tda._check_kernel_inputs(q, k, v, bl, bbt)
    kq = tkq.quantize_kv(k)
    with pytest.raises(ValueError, match="share one dtype"):
        tda._check_kernel_inputs(q, kq, v, lengths, bt)
    tda._check_kernel_inputs(q.bfloat16(), kq, tkq.quantize_kv(v), lengths, bt)
    tda._check_kernel_inputs(q.bfloat16(), k, v, lengths, bt)  # mixed q/KV


# -- int8 --------------------------------------------------------------------


def test_quantize_blocks_bit_identical_to_jax():
    """Payloads and scales equal JAX's bit for bit: random rows, an
    all-zero block (scale 1.0), and exact half-way ties (round half to
    even: 0.5, 1.5, 2.5, -0.5 of a scale)."""
    x = _rand((4, 7, 3, 16), 11) * 3
    x[0, 0, 0] = 0.0
    tie = np.zeros(16, np.float32)
    tie[:5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    x[1, 2, 1] = tie
    for dim in (-1, 1):
        jq, js = jrc.quantize_blocks(jnp.asarray(x), axis=dim)
        tq, ts = trc.quantize_blocks(torch.from_numpy(x), dim=dim)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            trc.dequantize_blocks(tq, ts).numpy(),
            np.asarray(jrc.dequantize_blocks(jq, js)),
        )
    jkv_, tkv_ = jkq.quantize_kv(jnp.asarray(x)), tkq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tkv_.q.numpy(), np.asarray(jkv_.q))
    np.testing.assert_array_equal(tkv_.scale.numpy(), np.asarray(jkv_.scale))
    assert tkv_.q[0, 0, 0].abs().sum() == 0 and tkv_.scale[0, 0, 0].item() == 1.0
    assert tkv_.q[1, 2, 1, :5].tolist() == [127, 0, 2, 2, 0]


def test_kv_wire_bytes_per_row_matches_jax():
    for h, d in ((4, 64), (12, 64), (2, 16)):
        assert tkq.kv_wire_bytes_per_row(h, d, "int8") == jkq.kv_wire_bytes_per_row(h, d, "int8")
        assert tkq.kv_wire_bytes_per_row(h, d, torch.int8) == h * (d + 4)
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            assert tkq.kv_wire_bytes_per_row(h, d, tdt) == jkq.kv_wire_bytes_per_row(h, d, jdt)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_attention_matches_jax(paged):
    """Quantized K/V through each package's plain attention: the same
    int8 bytes dequantized to f32 on both sides, f32 sums in different
    orders, hence 2e-5; ``visited`` equals ``num_kv_blocks``."""
    t = 3
    if paged:
        q, k, v, lengths, bt = _paged_case(4, t, 2, 16, 8, 4, [0, 5, 17, 29])
        jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
        tk = tkq.QuantizedKV(_torch_pool(np.asarray(jk.q)), _torch_pool(np.asarray(jk.scale)))
        tv = tkq.QuantizedKV(_torch_pool(np.asarray(jv.q)), _torch_pool(np.asarray(jv.scale)))
        want = jda.flash_paged_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(bt)
        )
        got, vis = tda.flash_paged_decode_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(lengths),
            torch.from_numpy(bt), return_visited=True,
        )
        s, bk = 32, tda.pick_block_k(8)
    else:
        q, k, v = _rand((4, t, 2, 16), 20), _rand((4, 32, 2, 16), 21), _rand((4, 32, 2, 16), 22)
        lengths = np.asarray([0, 5, 17, 29], np.int32)
        jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
        tk, tv = tkq.quantize_kv(torch.from_numpy(k)), tkq.quantize_kv(torch.from_numpy(v))
        want = jda.flash_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lengths))
        got, vis = tda.flash_decode_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(lengths), return_visited=True
        )
        s, bk = 32, tda.pick_block_k(32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(vis.numpy(), tda.num_kv_blocks(lengths, t, s, bk))


# -- the model through the paged path -------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    params = jax.jit(jgpt2.GPT2(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    return jcfg, params, tmodel


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_forward_prefill_chunk_then_decode(pair, quantized):
    """A padded prefill chunk with a write floor (slot 1's first page is
    slot 0's) and two decode ticks through ``GPT2(paged_cache=...)``:
    hiddens within 1e-4 of JAX's, and the pool's written pages equal up
    to the same tolerance (int8 payloads: within one step of rounding)."""
    jcfg, params, tmodel = pair
    ps, n_ps, p, slots, w = 4, 8, 20, 2, 6
    bt = np.zeros((slots, n_ps), np.int32)
    bt[0, :3] = [5, 2, 9]
    bt[1, :3] = [5, 11, 3]  # page 5 shared: slot 1 writes from position 4
    jfwd = jax.jit(
        lambda prm, toks, c: jgpt2.GPT2(jcfg).apply(
            {"params": prm}, toks, paged_cache=c, return_hidden=True
        )
    )
    jpool = jkv.alloc_paged_cache(jcfg, slots, p, ps, quantized=quantized)
    jk, jv = jpool.k, jpool.v
    tpool = tkv.alloc_paged_cache(
        tmodel.cfg, slots, p, ps, device="cpu", quantized=quantized
    )
    rng = np.random.default_rng(7)

    def step(toks, lengths, valid):
        nonlocal jk, jv
        hj, (jk, jv) = jfwd(params, jnp.asarray(toks), (
            jk, jv, jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(valid)
        ))
        with torch.no_grad():
            ht, _ = tmodel(
                torch.from_numpy(toks).long(),
                paged_cache=(tpool.k, tpool.v, torch.from_numpy(lengths),
                             torch.from_numpy(bt), torch.from_numpy(valid)),
                return_hidden=True,
            )
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-4)

    # Slot 0 prefills 6 tokens; slot 1's first 4 positions are slot 0's
    # page (the floor), so it writes positions 4..5 only. Padding rows
    # of the 6-wide chunk would run past nothing here, but rows past the
    # chunk length are masked all the same.
    toks = rng.integers(0, jcfg.vocab_size, (slots, w)).astype(np.int32)
    toks[1, :4] = toks[0, :4]
    valid = np.ones((slots, w), bool)
    valid[1, :4] = False
    step(toks, np.zeros(slots, np.int32), valid)
    lengths = np.asarray([w, w], np.int32)
    for _ in range(2):
        step(rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32),
             lengths, np.ones((slots, 1), bool))
        lengths = lengths + 1
    pages = sorted({int(x) for x in bt[:, :3].ravel()})
    for jbuf, tbuf in ((jk, tpool.k), (jv, tpool.v)):
        for jx, tx in zip(_parts(jbuf), _parts(tbuf)):
            jx, tx = np.asarray(jx)[:, pages], tx[:, pages].numpy()
            if jx.dtype == np.int8:
                assert np.abs(tx.astype(int) - jx.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-4)


def test_paged_positions_clip_to_the_table(pair):
    """Padding rows of a chunk can run past ``max_seq_len``: positions
    clip as in JAX, and their writes go to the trash page instead of
    raising."""
    jcfg, params, tmodel = pair
    cfg = tmodel.cfg
    ps, n_ps = 8, cfg.max_seq_len // 8
    pool = tkv.alloc_paged_cache(cfg, 1, n_ps, ps, device="cpu")
    bt = torch.arange(n_ps, dtype=torch.int32)[None]
    toks = torch.zeros((1, 6), dtype=torch.long)
    lengths = torch.tensor([cfg.max_seq_len - 2], dtype=torch.int32)
    valid = torch.tensor([[True, True, False, False, False, False]])
    with torch.no_grad():
        h, _ = tmodel(toks, paged_cache=(pool.k, pool.v, lengths, bt, valid),
                      return_hidden=True)
    assert torch.isfinite(h).all()
    assert pool.k[:, -1].abs().sum() > 0  # the trash page took the rows
    jpool = jkv.alloc_paged_cache(jcfg, 1, n_ps, ps)
    jh, _ = jax.jit(
        lambda prm, toks, c: jgpt2.GPT2(jcfg).apply(
            {"params": prm}, toks, paged_cache=c, return_hidden=True
        )
    )(params, jnp.asarray(toks.numpy(), jnp.int32), (
        jpool.k, jpool.v, jnp.asarray(lengths.numpy()),
        jnp.asarray(bt.numpy()), jnp.asarray(valid.numpy()),
    ))
    np.testing.assert_allclose(h[:, :2].numpy(), np.asarray(jh)[:, :2], rtol=1e-4, atol=1e-4)


def test_dataclass_shape_and_indexing():
    qkv = tkq.quantize_kv(torch.from_numpy(_rand((2, 5, 3, 16), 30)))
    assert qkv.shape == (2, 5, 3, 16) and qkv.dtype == torch.int8
    sub = qkv[:, 1:3]
    assert sub.q.shape == (2, 2, 3, 16) and sub.scale.shape == (2, 2, 3, 1)
    other = dataclasses.replace(qkv, q=qkv.q.clone(), scale=qkv.scale.clone())
    other[:, 0] = qkv[:, 4]
    assert torch.equal(other.q[:, 0], qkv.q[:, 4])
    assert torch.equal(other.scale[:, 0], qkv.scale[:, 4])
