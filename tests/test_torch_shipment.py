"""mpit_tpu_torch's KV shipment and the engine's KV export/inject against
the JAX package's, on the CPU.

- ``pack_shipment``'s header, meta and payload are bit-identical to
  ``mpit_tpu.serve.shipment.pack_shipment``'s for f32, bf16 and int8
  K/V (the same leaf bits fed to both), and each package unpacks the
  other's bytes;
- ``Engine.export_kv_rows`` after the fleet's prefill, from weights
  converted from JAX's, is within 1e-5 of JAX's in f32, and int8 K/V
  ship the very q bytes JAX's do (scales within 1e-6 relative);
- rows exported from a dense engine inject into a paged one and come
  back out equal (and the reverse);
- after pack → unpack → inject, decode on a second engine gives the
  tokens of the engine that prefilled, run as a single ``Server``.

On the CPU the payload is a CPU tensor and moves through the copy
kernel's plain version; the kernel itself is held in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import fleet as jfleet
from mpit_tpu.serve import shipment as jship
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs.trace import Ledger
from mpit_tpu_torch.serve import Engine, Request, Server, params_from_jax
from mpit_tpu_torch.serve import fleet as tfleet
from mpit_tpu_torch.serve import shipment as tship

JCFG = JConfig.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=jnp.float32,
)
TCFG = GPT2Config.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=torch.float32,
)
DENSE = dict(slots=2, max_len=32, prefill_len=8)
PAGED = dict(slots=2, max_len=40, prefill_len=8, kv_pages=24, kv_page_size=4,
             prefill_chunk=4)
MSG = {"rid": "q0", "prompt": [5, 9, 3, 1, 2, 7], "max_new_tokens": 5,
       "temperature": 0.0, "top_k": 0, "eos_id": None}


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


def _leaves(kind: str):
    """The same leaf bits as numpy (for JAX) and as tensors (the port)."""
    rng = np.random.default_rng(0)
    shape = (2, 5, 2, 16)
    if kind == "int8":
        q = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        s = [rng.random(shape[:-1] + (1,)).astype(np.float32) for _ in range(2)]
        np_leaves = [jship._QuantPair(q=q[i], scale=s[i]) for i in range(2)]
        t_leaves = [
            tship._QuantPair(q=torch.from_numpy(q[i]), scale=torch.from_numpy(s[i]))
            for i in range(2)
        ]
        return np_leaves, t_leaves
    if kind == "bf16":
        bits = [rng.integers(0, 2**16, shape).astype(np.uint16) for _ in range(2)]
        return (
            [b.view(ml_dtypes.bfloat16) for b in bits],
            [torch.from_numpy(b.view(np.int16)).view(torch.bfloat16) for b in bits],
        )
    f = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    return f, [torch.from_numpy(x) for x in f]


def _ship(mod, k, v, quantized):
    return mod.KVShipment(
        rid="w0", prompt=[5, 9, 3, 1, 2], first_token=7, length=5,
        max_new_tokens=4, temperature=0.5, top_k=3, eos_id=11,
        quantized=quantized, k=k, v=v,
    )


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_wire_bytes_equal_jax(kind):
    (jk, jv), (tk, tv) = _leaves(kind)
    want = jship.pack_shipment(_ship(jship, jk, jv, kind == "int8"))
    got = tship.pack_shipment(_ship(tship, tk, tv, kind == "int8"))
    assert got[0].dtype == torch.int64 and got[1].dtype == got[2].dtype == torch.uint8
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # Each package reads the other's bytes back to the same leaves.
    back = tship.unpack_shipment(torch.from_numpy(np.array(want[1])),
                                 torch.from_numpy(np.array(want[2])))
    jback = jship.unpack_shipment(got[1].numpy(), got[2].numpy())
    names = [n for n, _ in back.leaves()]
    assert names == [n for n, _ in jback.leaves()]
    for (_, t), (_, j), (_, orig) in zip(back.leaves(), jback.leaves(),
                                         _ship(tship, tk, tv, kind == "int8").leaves()):
        assert t.dtype == orig.dtype and t.shape == orig.shape
        assert torch.equal(t.view(torch.uint8), orig.contiguous().view(torch.uint8))
        assert np.asarray(j).tobytes() == orig.contiguous().view(torch.uint8).numpy().tobytes()
    assert (back.rid, back.first_token, back.eos_id, back.top_k) == ("w0", 7, 11, 3)


def test_unpack_refuses_a_short_payload():
    (_, _), (tk, tv) = _leaves("f32")
    _, meta, payload = tship.pack_shipment(_ship(tship, tk, tv, False))
    with pytest.raises(ValueError, match="size mismatch"):
        tship.unpack_shipment(meta, payload[:-4])


def _kv_pair(rows):
    return [rows.q, rows.scale] if hasattr(rows, "q") else [rows]


@pytest.mark.parametrize("geo,kv_dtype", [
    (DENSE, None), (PAGED, None), (DENSE, "int8"), (PAGED, "int8"),
], ids=["dense-f32", "paged-f32", "dense-int8", "paged-int8"])
def test_export_kv_rows_matches_jax(params, geo, kv_dtype):
    """The fleet's prefill on slot 0, then the exported rows."""
    kw = dict(geo, kv_dtype=kv_dtype, decode_attention="reference")
    jeng = JEngine(JCFG, params["jax"], **kw)
    teng = Engine(TCFG, params["torch"], device="cpu", **kw)
    jship_, _ = jfleet._prefill_one(jeng, MSG, Ledger(mode="aggregate"))
    tship_, _ = tfleet._prefill_one(teng, MSG, Ledger(mode="aggregate"))
    assert tship_.first_token == jship_.first_token
    assert tship_.quantized == jship_.quantized == (kv_dtype == "int8")
    for tl, jl in zip((tship_.k, tship_.v), (jship_.k, jship_.v)):
        for t, j in zip(_kv_pair(tl), _kv_pair(jl)):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape == (
                (2, 6, 2, 1) if t.shape[-1] == 1 else (2, 6, 2, 16)
            )
            if t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), j)
            elif kv_dtype == "int8":
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
            else:
                np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_dense_paged_export_inject_round_trip(params, kv_dtype):
    dense = Engine(TCFG, params["torch"], device="cpu", kv_dtype=kv_dtype, **DENSE)
    paged = Engine(TCFG, params["torch"], device="cpu", kv_dtype=kv_dtype, **PAGED)
    ship, _ = tfleet._prefill_one(dense, MSG, Ledger(mode="aggregate"))
    n = ship.length
    assert paged.allocator.admit(1, MSG["prompt"], MSG["max_new_tokens"]) is not None
    paged.inject_kv_rows(1, ship.k, ship.v, n, ship.first_token)
    back = paged.export_kv_rows(1, n)
    assert int(paged.lengths()[1]) == n and int(paged.last_token[1]) == ship.first_token
    dense.reset()
    dense.inject_kv_rows(1, back[0], back[1], n, ship.first_token)
    again = dense.export_kv_rows(1, n)
    for rows in (back, again):
        for got, want in zip(rows, (ship.k, ship.v)):
            for g, w in zip(_kv_pair(got), _kv_pair(want)):
                assert torch.equal(g, w)


@pytest.mark.parametrize("geo,kv_dtype", [(DENSE, None), (PAGED, "int8")],
                         ids=["dense-f32", "paged-int8"])
def test_injected_decode_equals_prefilling_engine(params, geo, kv_dtype):
    """Prefill on one engine, ship through the wire, inject into a second
    and decode there: the tokens equal the first engine's own Server run
    (int8 q and scale blocks survive the wire bit for bit)."""
    n_new = MSG["max_new_tokens"]
    src = Engine(TCFG, params["torch"], device="cpu", kv_dtype=kv_dtype, **geo)
    ledger = Ledger(mode="aggregate", origin_rank=1)
    ship, _ = tfleet._prefill_one(src, MSG, ledger)
    _, meta, payload = tship.pack_shipment(ship, ledger=ledger)
    wire = tship.unpack_shipment(meta, payload, ledger=ledger)
    dst = Engine(TCFG, params["torch"], device="cpu", kv_dtype=kv_dtype, **geo)
    if dst.paged:
        assert dst.allocator.admit(0, MSG["prompt"], n_new) is not None
    tship.inject_shipment(dst, 0, wire, ledger=ledger)
    tokens = [int(wire.first_token)]
    active = np.zeros((dst.slots,), bool)
    active[0] = True
    temp = np.zeros((dst.slots,), np.float32)
    topk = np.zeros((dst.slots,), np.int32)
    while len(tokens) < n_new:
        tokens.append(int(dst.decode(active, temp, topk)[0]))
    src.reset()
    server = Server(src)
    server.submit(Request(rid="q0", prompt=MSG["prompt"], max_new_tokens=n_new))
    (done,) = server.run()
    assert tokens == list(done.tokens)
    assert ledger.counts == {"fleet_prefill": 1, "kv_ship_pack": 1,
                             "kv_ship_unpack": 1, "kv_ship_inject": 1}


def test_ship_kv_remote_on_the_cpu():
    """A copy on the same device, through the plain version; another
    card waits for the multi-card form."""
    buf = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    out = tship.ship_kv_remote(buf, 0)
    assert torch.equal(out, buf) and out.data_ptr() != buf.data_ptr()
    assert torch.equal(tship.ship_kv_remote(buf.t(), "cpu"), buf.t())
    with pytest.raises(NotImplementedError, match="§A 14"):
        tship.ship_kv_remote(buf, "meta")


def test_recv_shipment_needs_its_device():
    """``recv_shipment``'s ``device`` is a required keyword: the payload
    lands where the sender packed it, and nothing defaults to the CPU."""
    from mpit_tpu_torch.serve.shipment import recv_shipment

    with pytest.raises(TypeError, match="device"):
        recv_shipment(0, None)


def test_ship_bytes_refusals_on_the_cpu():
    """The copy wrapper's checks hold before any path: one device, known
    devices, contiguous ranges of equal size that do not overlap, and a
    body the kernel has (``wave``, ``stream`` or the plan's choice); a
    named body leaves a CPU copy on the plain version."""
    from mpit_tpu_torch.ops import kv_ship

    before = (kv_ship.launches["kv_ship"], dict(kv_ship.path_launches))
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    out = torch.empty_like(x)
    for body in (None, *kv_ship.BODIES):
        out.zero_()
        assert kv_ship.ship_bytes(x, out, body=body) is out and torch.equal(out, x)
    with pytest.raises(ValueError, match="body must be one of"):
        kv_ship.ship_bytes(x, out, body="tma")
    with pytest.raises(ValueError, match="contiguous"):
        kv_ship.ship_bytes(x.transpose(0, 1), torch.empty(3, 2, 4))
    with pytest.raises(ValueError, match="bytes"):
        kv_ship.ship_bytes(x, torch.empty(2, 3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="overlap"):
        kv_ship.ship_bytes(x.view(-1)[:10], x.view(-1)[5:15])
    with pytest.raises(ValueError, match="no copy kernel"):
        kv_ship.ship_bytes(torch.empty(4, device="meta"), torch.empty(4, device="meta"))
    assert (kv_ship.launches["kv_ship"], kv_ship.path_launches) == before
