"""mpit_tpu_torch's ring collectives against mpit_tpu's, on the CPU.

The port's collectives take rank-stacked tensors (row ``r`` is rank
``r``'s); JAX's run inside ``shard_map`` on sub-meshes of the fake CPU
devices (``p`` = 2 and 4). On the CPU the port runs the kernels' plain
versions, which take the ring order hop by hop. Inputs are made by numpy
from a seed and handed to both packages. Tolerances, with their reasons:

- planner geometry, wire bytes, the host-side wire layouts, int8 bytes
  and scales: exact (integer and bookkeeping paths);
- the sum forms on integer-valued data: exact (every partial sum is an
  integer that f32 and bf16 hold exactly, in any order);
- the sum reduce-scatter on normal data: rtol 2e-6. JAX's fallback is
  ``lax.psum_scatter``, which sums the ranks in another order than the
  ring; at ``p = 2`` the two orders are one addition and agree exactly;
- the q8 all-gather against JAX's ppermute-spelled ring: exact (one
  quantization, then a product per element, as in the port);
- the q8 reduce-scatter against the same ring, the same per-hop
  quantize, ship, dequantize and add in the same order: within
  ``(p - 1) · 2.5e-7 · max |result|``. XLA's CPU compiler contracts
  the dequantizing product and the add into one FMA (one rounding);
  the port rounds twice, as its CUDA kernel does, so a partial can
  differ by about an ulp a hop (measured at p 2, 4, 8: at most 5.7e-6
  on results up to about 20). A hop's int8 rounding moved by such a
  difference would show as a whole quantization step (about 0.1 here);
  none occurs on these inputs. The q8 allreduce, whose all-gather
  quantizes that result again, is held to the port's own composition
  exactly and to JAX's within one more quantization step;
- one tiny case against the Pallas kernel in TPU interpret mode: q8
  reduce-scatter at p = 2, the reduce-scatter tolerance above;
- the models of the one-card kernels' arithmetic (the sum fold, the
  copy, the q8 fold, the q8 copy) against the plain ring, hop by hop:
  exact; the q8 copy's model in every bit, signed zeros too.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu import _jaxcompat
from mpit_tpu.ops import ring_allreduce as j_allreduce
from mpit_tpu_torch import comm
from mpit_tpu_torch.ops.ring_allreduce import ring_allreduce

jrc = importlib.import_module("mpit_tpu.ops.ring_collectives")
trc = importlib.import_module("mpit_tpu_torch.ops.ring_collectives")

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


@pytest.fixture(scope="module")
def worlds():
    return {
        p: mpit_tpu.init({"data": p}, devices=jax.devices()[:p], set_default=False)
        for p in (2, 4)
    }


def _jax_sharded(world, fn, x, out_spec=P("data")):
    f = world.shard_map(fn, in_specs=P("data"), out_specs=out_spec, check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _fma_close(got, want, p):
    """The q8 reduce-scatter's tolerance against XLA's FMA-contracted
    CPU code (module docstring)."""
    np.testing.assert_allclose(got, want, rtol=0, atol=(p - 1) * 2.5e-7 * np.abs(want).max())


def _data(seed, shape, kind, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-8, 9, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_plans_and_wire_bytes_equal_jax(p, dtype):
    jdt = _JDT[dtype]
    for n in (1, 127, 128, 1000, 4096, 12345, p * 128 * 33):
        for plan_fn in ("plan_ring", "plan_shards"):
            mine = getattr(trc, plan_fn)(n, p, dtype)
            want = getattr(jrc, plan_fn)(n, p, jdt)
            assert (mine.p, mine.chunk_rows, mine.padded_rows) == (
                want.p, want.chunk_rows, want.padded_rows
            )
            assert mine.wire_rows == want.wire_rows
            for scales in (False, True):
                assert mine.wire_payload_bytes(dtype, scales=scales) == want.wire_payload_bytes(
                    jdt, scales=scales
                )
    assert trc.sublane_for(dtype) == jrc.sublane_for(jdt)
    for bad in (0, -3):
        with pytest.raises(ValueError):
            trc.plan_ring(bad, p, dtype)


def test_wire_layouts_equal_jax():
    x = _data(0, 1000, "normal")
    plan, jplan = trc.plan_ring(1000, 3, torch.bfloat16), jrc.plan_ring(1000, 3, jnp.bfloat16)
    wire = plan.to_wire(torch.from_numpy(x))
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jplan.to_wire(jnp.asarray(x))))
    np.testing.assert_array_equal(
        plan.full_from_wire(wire).numpy(), np.asarray(jplan.full_from_wire(jnp.asarray(wire)))
    )
    np.testing.assert_array_equal(
        plan.shard_from_wire(wire[: plan.padded_rows]).numpy(),
        np.asarray(jplan.shard_from_wire(jnp.asarray(wire[: plan.padded_rows]))),
    )
    splan, jsplan = trc.plan_shards(300, 4, torch.float32), jrc.plan_shards(300, 4, jnp.float32)
    sw = splan.shard_to_wire(torch.from_numpy(x[:300]))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsplan.shard_to_wire(jnp.asarray(x[:300]))))
    full = torch.from_numpy(_data(1, (4 * splan.padded_rows, 128), "normal"))
    np.testing.assert_array_equal(
        splan.gathered_from_wire(full, 300).numpy(),
        np.asarray(jsplan.gathered_from_wire(jnp.asarray(full.numpy()), 300)),
    )
    # Leading (rank) dimensions are carried through.
    stacked = plan.to_wire(torch.from_numpy(np.stack([x, 2 * x])))
    np.testing.assert_array_equal(stacked[1].numpy(), 2 * wire.numpy())


@pytest.mark.parametrize("case", ["normal", "zeros", "extremes", "bf16"])
def test_quantize_chunk_bit_identical(case):
    x = _data(2, (16, 128), "normal") * 3.0
    if case == "zeros":
        x = np.zeros((16, 128), np.float32)
    elif case == "extremes":
        x[0, 0], x[1, 1] = 1e4, -1e4
    t = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if case == "bf16":
        t, jx = t.bfloat16(), jx.astype(jnp.bfloat16)
    q, s = trc.quantize_chunk(t)
    jq, js = jrc.quantize_chunk(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32 and s.item() == float(js)
    np.testing.assert_array_equal(
        trc.dequantize_chunk(q, s).numpy(), np.asarray(jrc.dequantize_chunk(jq, js))
    )
    if case == "zeros":
        assert s.item() == 1.0
    if case == "extremes":
        assert np.abs(q.numpy()).max() == 127


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize(
    "kind,dtype", [("int", torch.float32), ("int", torch.bfloat16), ("normal", torch.float32)]
)
def test_sum_reduce_scatter_and_all_gather_match_jax(worlds, p, kind, dtype):
    n = 3 * 1000  # not a multiple of p·128: the planner pads
    x = _data(10 + p, (p, n), kind)
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(_JDT[dtype])
    got = trc.ring_reduce_scatter(tx)
    want = _jax_sharded(worlds[p], lambda v: jrc.ring_reduce_scatter(v, "data"), jx.reshape(-1))
    assert got.dtype == dtype and got.shape[0] == p
    exact = kind == "int" or p == 2
    np.testing.assert_allclose(
        got.float().numpy().reshape(-1), np.asarray(want, np.float32),
        rtol=0 if exact else 2e-6, atol=0 if exact else 2e-6,
    )
    shards = torch.from_numpy(x[:, :700]).to(dtype)
    gathered = trc.ring_all_gather(shards, out_size=p * 700 - 5)
    jg = _jax_sharded(
        worlds[p], lambda v: jrc.ring_all_gather(v, "data", out_size=p * 700 - 5),
        jnp.asarray(x[:, :700]).astype(_JDT[dtype]).reshape(-1), out_spec=P(None),
    )
    for r in range(p):
        np.testing.assert_array_equal(gathered[r].float().numpy(), np.asarray(jg, np.float32))


def _fold_model(xs):
    """The one-card sum reduce-scatter kernel's arithmetic (``rs_fold_kernel``
    in ``csrc/ring_collectives.cu``): for rank ``r``, chunk ``r`` of every
    rank summed in the ring's order, ``acc = x[r+1][r]``, then ``acc =
    round_T(acc + x[r+j][r])`` for ``j = 2..p`` (ranks mod p), each add in
    f32 and rounded to the dtype."""
    p = xs.shape[0]
    out = []
    for r in range(p):
        acc = xs[(r + 1) % p, r].float()
        for j in range(2, p + 1):
            acc = (acc + xs[(r + j) % p, r].float()).to(xs.dtype).float()
        out.append(acc.to(xs.dtype))
    return torch.stack(out)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "int"])
def test_fold_order_equals_ring_hops(worlds, p, dtype, kind):
    """The fold's order and roundings are the hop schedule's: its model
    equals :func:`reduce_scatter_plain` (the ring, hop by hop) bit for
    bit, and the wrapper's CPU path, at rows 1 and 37. At p 4 it also
    meets JAX's ``ring_reduce_scatter`` as
    ``test_sum_reduce_scatter_and_all_gather_match_jax`` does: exactly on
    integer data, within 2e-6 on normal f32 data (JAX sums the ranks in
    another order); bf16 on normal data is not compared there, since
    another order moves bf16 sums by whole steps."""
    for rows in (1, 37):
        x = _data(70 + p + rows, (p, p * rows * 128), kind)
        xs = torch.from_numpy(x).to(dtype).reshape(p, p, rows, 128)
        got = _fold_model(xs)
        assert torch.equal(got, trc.reduce_scatter_plain(xs))
        assert torch.equal(got, trc.reduce_scatter_chunks(xs))
        if p != 4 or (dtype == torch.bfloat16 and kind == "normal"):
            continue
        want = _jax_sharded(
            worlds[p], lambda v: jrc.ring_reduce_scatter(v, "data"),
            jnp.asarray(x).astype(_JDT[dtype]).reshape(-1),
        )
        tol = 0 if kind == "int" else 2e-6
        np.testing.assert_allclose(
            got.float().numpy().reshape(-1), np.asarray(want, np.float32), rtol=tol, atol=tol
        )


def _copy_model(shards):
    """The one-card sum all-gather kernel's work (``ag_copy_kernel`` in
    ``csrc/ring_collectives.cu``): shard ``c`` read once and stored, as
    it is, into chunk ``c`` of every rank's output."""
    p = shards.shape[0]
    out = shards.new_empty((p, *shards.shape))
    for c in range(p):
        for r in range(p):
            out[r, c] = shards[c]
    return out


@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_equals_ring_all_gather(p, dtype):
    """The copy's result is the ring's: its model equals
    :func:`all_gather_plain` (the ring, hop by hop) and the wrapper's CPU
    path bit for bit, at rows 1 and 37, every replica the same."""
    for rows in (1, 37):
        shards = torch.from_numpy(_data(90 + p + rows, (p, rows * 128), "normal"))
        shards = shards.to(dtype).reshape(p, rows, 128)
        got = _copy_model(shards)
        assert torch.equal(got, trc.all_gather_plain(shards))
        assert torch.equal(got, trc.all_gather_chunks(shards))
        assert all(torch.equal(got[r], got[0]) for r in range(p))


def _q8_fold_model(xs, blocks):
    """The one-card q8 reduce-scatter kernel's arithmetic (the q8 fold,
    ``rs_q8_fold_kernel`` in ``csrc/ring_collectives.cu``): for rank
    ``r``, ``min(blocks, rows)`` blocks each carry their rows of chunk
    ``r``'s partial hop to hop, ``P0 = f32(x[r+1][r])``, then ``Pj =
    f32(clip(round(P / s), ±127)) · s + f32(x[r+1+j][r])``, each step
    rounded once, ``s`` the scale of the blocks' amaxes merged by max
    (the kernel's amax barrier)."""
    p, _, rows, _ = xs.shape
    nblk = min(blocks, rows)
    spans = [(b * rows // nblk, (b + 1) * rows // nblk) for b in range(nblk)]
    out = []
    for r in range(p):
        parts = [xs[(r + 1) % p, r, lo:hi].float() for lo, hi in spans]
        for j in range(1, p):
            amax = torch.stack([part.abs().amax() for part in parts]).amax()
            s = torch.where(amax > 0, amax / torch.tensor(127.0), 1.0)
            mine = xs[(r + 1 + j) % p, r].float()
            parts = [torch.clamp(torch.round(part / s), -127, 127) * s + mine[lo:hi]
                     for part, (lo, hi) in zip(parts, spans)]
        out.append(torch.cat(parts))
    return torch.stack(out)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_fold_equals_ring_hops(worlds, p, dtype):
    """The q8 fold's arithmetic is the hop schedule's: its model (as many
    blocks a rank as one 132-SM card gives, so several share a chunk's
    amax) equals :func:`reduce_scatter_plain` with ``quantized`` and the
    wrapper's CPU path bit for bit, at rows 1 and 37, and with one chunk
    zero on every rank and one rank's copy of another zero (scale 1). At
    p 4 in f32 it also meets JAX's ``ring_reduce_scatter(op="qsum")``
    within the q8 reduce-scatter's FMA bound (module docstring)."""
    for rows, zero in ((1, False), (37, False), (37, True)):
        x = _data(110 + p + rows, (p, p * rows * 128), "normal")
        x *= np.linspace(0.5, 3.0, p, dtype=np.float32)[:, None]
        xs = torch.from_numpy(x).to(dtype).reshape(p, p, rows, 128)
        if zero:
            xs[:, p - 1] = 0  # chunk p - 1's partials are zero at every hop
            xs[1, 0] = 0  # chunk 0's P0 is zero
        got = _q8_fold_model(xs, 132 // p)
        assert got.dtype == torch.float32
        assert torch.equal(got, trc.reduce_scatter_plain(xs, quantized=True))
        assert torch.equal(got, trc.reduce_scatter_chunks(xs, quantized=True))
        if zero:
            assert not got[p - 1].any()
        if p == 4 and dtype == torch.float32 and rows == 37:
            want = _jax_sharded(
                worlds[p], lambda v: jrc.ring_reduce_scatter(v, "data", op="qsum"),
                xs.numpy().reshape(-1),
            )
            _fma_close(got.numpy().reshape(-1), want, p)


def _bits(t):
    """``t``'s elements as integers of their width: equal bits, signed
    zeros too, where ``torch.equal`` of the floats takes -0 for +0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _q8_copy_model(shards, blocks):
    """The one-card q8 all-gather kernel's arithmetic (the q8 copy,
    ``ag_q8_copy_kernel`` in ``csrc/ring_collectives.cu``): for shard
    ``c``, ``min(blocks, rows)`` blocks each take the amax of their rows,
    merged by max (the kernel's amax barrier) into the scale ``s``; each
    element becomes ``f32(clip(round(x / s), ±127) + 0) · s`` (``+ 0``:
    the int8 value it stands for has no sign, so -0 becomes +0), rounded
    once to the shards' dtype and written into chunk ``c`` of every
    rank's output."""
    p, rows, _ = shards.shape
    nblk = min(blocks, rows)
    spans = [(b * rows // nblk, (b + 1) * rows // nblk) for b in range(nblk)]
    out = shards.new_empty((p, *shards.shape))
    for c in range(p):
        x = shards[c].float()
        amax = torch.stack([x[lo:hi].abs().amax() for lo, hi in spans]).amax()
        s = torch.where(amax > 0, amax / torch.tensor(127.0), 1.0)
        q = torch.clamp(torch.round(x / s), -127, 127) + 0.0
        out[:, c] = (q * s).to(shards.dtype)
    return out


@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_gather_equals_ring_all_gather(worlds, p, dtype):
    """The q8 copy's arithmetic is the ring's: its model (as many blocks
    a chunk as one 132-SM card gives, so several share a chunk's amax)
    equals :func:`all_gather_plain` with ``quantized`` and the wrapper's
    CPU path in every bit, every replica the same, at rows 1 and 37, and
    with one chunk zero (scale 1) and one whose amax lies in its last
    block only. At p 4 in f32 it also equals JAX's
    ``ring_all_gather(quantized=True)`` in every bit."""
    for rows, special in ((1, False), (37, False), (37, True)):
        x = _data(150 + p + rows, (p, rows * 128), "normal")
        x *= np.linspace(0.5, 3.0, p, dtype=np.float32)[:, None]
        shards = torch.from_numpy(x).to(dtype).reshape(p, rows, 128)
        if special:
            shards[p - 1] = 0
            shards[0] *= 1e-3  # its amax, 5.0, in the last row: the last block's
            shards[0, -1, 7] = 5.0
        got = _q8_copy_model(shards, 132 // p)
        assert torch.equal(_bits(got), _bits(trc.all_gather_plain(shards, quantized=True)))
        assert torch.equal(_bits(got), _bits(trc.all_gather_chunks(shards, quantized=True)))
        assert all(torch.equal(_bits(got[r]), _bits(got[0])) for r in range(p))
        if special:
            assert not got[:, p - 1].any()
            assert got[0, 0, -1, 7] == 5.0
        if p == 4 and dtype == torch.float32 and rows == 37 and not special:
            want = _jax_sharded(
                worlds[p], lambda v: jrc.ring_all_gather(v, "data", quantized=True),
                x.reshape(-1), out_spec=P(None),
            )
            np.testing.assert_array_equal(got[0].numpy().reshape(-1).view(np.int32),
                                          np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("p", [2, 4])
def test_q8_reduce_scatter_and_all_gather_match_jax(worlds, p):
    x = _data(20 + p, (p, 2000), "normal") * np.linspace(0.1, 4.0, p)[:, None].astype(np.float32)
    got = trc.ring_reduce_scatter(torch.from_numpy(x), op="qsum")
    want = _jax_sharded(
        worlds[p], lambda v: jrc.ring_reduce_scatter(v, "data", op="qsum"), x.reshape(-1)
    )
    assert got.dtype == torch.float32
    _fma_close(got.numpy().reshape(-1), want, p)
    gathered = trc.ring_all_gather(torch.from_numpy(x), quantized=True)
    jg = _jax_sharded(
        worlds[p], lambda v: jrc.ring_all_gather(v, "data", quantized=True), x.reshape(-1),
        out_spec=P(None),
    )
    for r in range(p):  # every replica the same bits, JAX's
        np.testing.assert_array_equal(gathered[r].numpy(), jg)
    full = ring_allreduce(torch.from_numpy(x), op="qsum")
    composed = trc.ring_all_gather(got, quantized=True, out_size=x.shape[1])
    np.testing.assert_array_equal(full.numpy(), composed.numpy())
    jfull = _jax_sharded(
        worlds[p], lambda v: j_allreduce(v, "data", op="qsum"), x.reshape(-1)
    ).reshape(p, -1)
    step = np.abs(jfull).max() / 127
    np.testing.assert_allclose(full.numpy(), jfull, rtol=0, atol=step)
    exact = ring_allreduce(torch.from_numpy(x))
    np.testing.assert_allclose(exact.numpy(), np.broadcast_to(x.sum(0), x.shape), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.skipif(not _jaxcompat.HAS_TPU_INTERPRET, reason="no Pallas TPU interpret mode")
def test_q8_reduce_scatter_matches_the_pallas_kernel_in_interpret_mode(worlds):
    x = _data(30, (2, 2 * 8 * 128), "normal")
    got = trc.ring_reduce_scatter(torch.from_numpy(x), op="qsum")
    want = _jax_sharded(
        worlds[2], lambda v: jrc.ring_reduce_scatter(v, "data", op="qsum", interpret=True),
        x.reshape(-1),
    )
    _fma_close(got.numpy().reshape(-1), want, 2)


def test_chunk_forms_take_strided_rows_and_write_into_out():
    """The gradient-sync bucket loop's calls: row ranges of flat buffers,
    read and written in place, equal the whole-buffer collective's rows."""
    p, rows = 3, 40
    x = torch.from_numpy(_data(40, (p, p, rows, 128), "normal"))
    whole = trc.reduce_scatter_plain(x, quantized=False)
    out = torch.zeros(p, rows, 128)
    for r0, r1 in ((0, 32), (32, 40)):
        trc.reduce_scatter_chunks(x[:, :, r0:r1], out=out[:, r0:r1])
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    full = torch.zeros(p, p, rows, 128)
    for r0, r1 in ((0, 32), (32, 40)):
        trc.all_gather_chunks(out[:, r0:r1], out=full[:, :, r0:r1])
    for r in range(p):
        np.testing.assert_array_equal(full[r].numpy(), whole.numpy())
    with pytest.raises(ValueError, match="out must be"):
        trc.reduce_scatter_chunks(x, quantized=True, out=torch.zeros(p, rows, 128).double())


@pytest.mark.parametrize("quantized", [False, True])
def test_one_rank_is_a_no_op(quantized):
    x = torch.from_numpy(_data(50, (1, 777), "normal"))
    got = trc.ring_reduce_scatter(x, op="qsum" if quantized else "sum")
    np.testing.assert_array_equal(got.numpy(), x.numpy())
    np.testing.assert_array_equal(
        trc.ring_all_gather(x, quantized=quantized, out_size=700).numpy(), x[:, :700].numpy()
    )
    assert ring_allreduce(x, op="qsum" if quantized else "sum") is x


def test_bad_inputs_and_devices_raise():
    with pytest.raises(ValueError, match="qsum"):
        trc.ring_reduce_scatter(torch.ones(2, 128), op="max")
    with pytest.raises(ValueError, match="qsum"):
        ring_allreduce(torch.ones(2, 128), op="mean")
    with pytest.raises(ValueError, match="rank-stacked"):
        trc.reduce_scatter_chunks(torch.ones(2, 2, 8, 64))
    with pytest.raises(ValueError, match="no ring kernel"):
        trc.all_gather_chunks(torch.ones(2, 8, 128, device="meta"))
    assert trc.executed_mode("sum", "cpu") == "ring_plain"
    assert trc.executed_mode("qsum", torch.device("cuda", 0)) == "ring"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            comm.init({"data": 2})


def test_obs_charges_wire_bytes_at_the_quantized_size():
    from mpit_tpu_torch import obs

    rec = obs.enable(obs.Recorder())
    try:
        x = torch.from_numpy(_data(60, (4, 4 * 128 * 512), "normal"))
        trc.ring_reduce_scatter(x)
        trc.ring_reduce_scatter(x, op="qsum")
    finally:
        obs.disable()
    counters = rec.summary()["counters"]
    plan = trc.plan_ring(x.shape[1], 4, torch.float32)
    qplan = trc.plan_ring(x.shape[1], 4, torch.int8)
    f32_bytes = plan.wire_payload_bytes(torch.float32)
    q8_bytes = qplan.wire_payload_bytes(torch.int8, scales=True)
    assert counters["ring_wire_bytes"] == f32_bytes + q8_bytes
    assert q8_bytes < 0.3 * f32_bytes
