"""mpit_tpu_torch's memory ledger against the JAX package's.

- :class:`~mpit_tpu_torch.obs.MemLedger` and the capacity verdict
  (:func:`capacity_report`, :func:`format_capacity`, the ``capacity``
  CLI's exit codes) equal JAX's for one grant / free / touch /
  exhaustion script;
- the page allocator's grants and frees (admission, a shared-prefix
  mapping with its COW reserve, the COW copy, reserve trims, retirement,
  reset) equal JAX's allocator's on the same script, ledger for ledger;
- each engine's decomposition (dense f32, paged bf16, int8 K/V, int8
  weights, host tier) equals JAX's engine's, but for one layout
  difference the test names: the port's page pool holds a trash page
  (``num_pages + 1`` pages; writes of slots taking no part land there),
  so its ``kv_pool`` line is one ``page_bytes`` larger; the draft of a
  speculative engine holds its own weights in the port (JAX's
  ``draft_from_target`` draft aliases the target's arrays);
- ``held()`` equals the bytes of every tensor the engine allocated,
  counted independently (tensor-parallel and speculative engines too),
  and ``granted − freed == held`` holds exactly, with the nested lines
  equal to the allocator's own page, reserve and slot counts, after
  every step of serving scripts (dense, a shared prefix with COW, a
  preemption onto the host tier, a pool exhaustion);
- a served run's ``stats()["memory"]`` (held decomposition, KV capacity
  and headroom, per-request bytes, eviction candidates, the exhaustion
  dump) equals JAX's server's for the same requests, but for the
  ``kv_pool`` line above; off the card the reconciliation reports no
  device bytes.
"""

from __future__ import annotations

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.obs import memledger as jmem
from mpit_tpu.obs.__main__ import main as jobs_main
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve.kvcache import PageAllocator as JPageAllocator
from mpit_tpu_torch import comm
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs import memledger as mem
from mpit_tpu_torch.obs.__main__ import main as obs_main
from mpit_tpu_torch.ops.kv_quant import kv_tensors
from mpit_tpu_torch.serve import (
    Engine,
    Request,
    SchedulingPolicy,
    Server,
    draft_from_target,
    params_from_jax,
)
from mpit_tpu_torch.serve.kvcache import PageAllocator

JCFG = JConfig.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                    dtype=jnp.float32)
TCFG = GPT2Config.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                       dtype=torch.float32)
GEOM = dict(slots=2, max_len=32, prefill_len=16)
PAGED = dict(GEOM, kv_pages=12, kv_page_size=4)
SYSP = [11, 12, 13, 14, 15]


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


def _ledger_script(mod):
    ml = mod.MemLedger(platform="cpu")
    ml.register("weights", capacity_bytes=1000)
    ml.grant("weights", 1000, kind="param_store")
    ml.register("kv_pool", capacity_bytes=4096)
    ml.grant("kv_pool", 4096)
    ml.register("kv_pages", capacity_bytes=4000, nested_in="kv_pool")
    ml.register("kv_cow_reserve", nested_in="kv_pool")
    ml.grant("kv_pages", 800, owner="a", tenant="t0", tick=1, kind="admit")
    ml.grant("kv_pages", 400, owner="b", tenant="t1", tick=2, kind="admit")
    ml.grant("kv_cow_reserve", 200, owner="b", tick=2)
    ml.grant("kv_pages", 200, owner="b", kind="cow_copy")
    ml.free("kv_cow_reserve", 200, kind="cow_copy")
    ml.touch("a", tick=5, state="parked")
    ml.free("kv_pages", 800, owner="a", kind="free_slot")
    ml.forget("a")
    ml.grant("unregistered", 7)
    ml.note_exhaustion({"tick": 4, "kv_headroom_bytes": 96,
                        "top_holders": [{"rid": "b", "bytes": 600}]})
    return ml


def test_ledger_script_equals_jax(tmp_path, capsys):
    mine, ref = _ledger_script(mem), _ledger_script(jmem)
    assert mine.snapshot() == ref.snapshot()
    assert mine.watermark() == ref.watermark()
    assert mine.headroom("kv_pages") == ref.headroom("kv_pages") == 3400
    assert mine.headroom("step_buffers") is None
    assert mine.conservation()["ok"]
    rec = mine.reconcile()
    assert rec == ref.reconcile() and rec["device_bytes"] is None
    report = mem.capacity_report(mine.snapshot())
    assert report == jmem.capacity_report(ref.snapshot())
    assert mem.format_capacity(report) == jmem.format_capacity(report)
    mine.reset_transients()
    ref.reset_transients()
    assert mine.snapshot() == ref.snapshot()
    for bad in (-1,):
        with pytest.raises(ValueError):
            mine.grant("weights", bad)
        with pytest.raises(ValueError):
            mine.free("weights", bad)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(mine.snapshot()))
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"phases": {}}))
    for p, want in ((path, 0), (junk, 2)):
        capsys.readouterr()
        assert obs_main(["capacity", str(p)]) == jobs_main(["capacity", str(p)]) == want
        out = capsys.readouterr().out
        half = len(out) // 2
        assert out[:half] == out[half:]  # both CLIs printed the same


def _allocator_script(cls, ml_mod):
    a = cls(num_pages=10, page_size=4, pages_per_slot=6, slots=3)
    ml = ml_mod.MemLedger(platform="cpu")
    ml.register("kv_pages", capacity_bytes=10 * 64, nested_in="kv_pool")
    ml.register("kv_cow_reserve", nested_in="kv_pool")
    a.memledger, a.page_bytes = ml, 64
    plans = [a.admit(0, SYSP + [20, 21], 4, owner="x", tenant="t", tick=1)]
    a.register_prefix(0, SYSP + [20, 21], tick=1)
    plans.append(a.admit(1, SYSP + [20, 21], 6, owner="y", tick=2))  # partial page shared
    pair = a.cow_before_write(1, 7)
    plans.append(a.admit(2, [1] * 9, 15, owner="z", tick=3))  # not now: None
    a.free_slot(0)
    a.free_slot(1)
    plans.append(a.admit(2, [9, 9], 3, owner="w", tick=4))
    mid = ml.snapshot()
    a.reset()
    return [(p.shared_tokens, p.pages) if p else None for p in plans], pair, mid, ml.snapshot()


def test_allocator_ledger_equals_jax():
    mine = _allocator_script(PageAllocator, mem)
    ref = _allocator_script(JPageAllocator, jmem)
    assert mine == ref
    plans, pair, mid, end = mine
    assert pair is not None and plans[2] is None
    assert mid["subsystems"]["kv_cow_reserve"]["grants"] == 1
    assert end["conservation"]["ok"] and end["held_bytes"] == 0


def _engines(params, kw, mode="reference"):
    jeng = JEngine(JCFG, params["jax"], decode_attention="reference", **GEOM, **kw)
    eng = Engine(TCFG, params["torch"], device="cpu", decode_attention=mode, **GEOM, **kw)
    return jeng, eng


@pytest.mark.parametrize("kw,mode", [
    ({}, "reference"),
    ({"kv_pages": 24, "kv_page_size": 4, "kv_dtype": "bf16"}, "reference"),
    ({"kv_dtype": "int8"}, "kernel"),
    ({"weights_dtype": "int8"}, "kernel"),
    ({"kv_pages": 24, "kv_page_size": 4, "kv_host_pages": 4}, "reference"),
], ids=["dense", "paged_bf16", "int8_kv", "int8_weights", "host_tier"])
def test_engine_decomposition_equals_jax(params, kw, mode):
    jeng, eng = _engines(params, kw, mode)
    js, ts = jeng.memledger.snapshot(), eng.memledger.snapshot()
    trash = eng.page_bytes if eng.paged else 0  # the port's trash page
    for snap in (js, ts):
        snap["subsystems"]["kv_pool"] = dict(snap["subsystems"]["kv_pool"])
    ts["subsystems"]["kv_pool"]["held_bytes"] -= trash
    ts["subsystems"]["kv_pool"]["granted_bytes"] -= trash
    ts["subsystems"]["kv_pool"]["peak_bytes"] -= trash
    ts["subsystems"]["kv_pool"]["capacity_bytes"] -= trash
    for key in ("held_bytes", "held_peak_bytes"):
        ts[key] -= trash
    ts["conservation"] = js["conservation"] = None
    assert ts["platform"] == js["platform"] == "cpu"
    assert ts == js
    assert (eng.page_bytes, eng.slot_bytes) == (jeng.page_bytes, jeng.slot_bytes)


def _tensor_bytes(engine) -> int:
    """Every distinct device tensor the engine holds, counted from the
    engine's own objects, independently of the ledger."""
    seen, total = set(), 0
    tensors = list(engine.model.state_dict().values())
    if engine.draft_model is not None:
        tensors += list(engine.draft_model.state_dict().values())
    for c in (engine.cache, engine.draft_cache):
        if c is not None:
            tensors += [*kv_tensors(c.k), *kv_tensors(c.v), c.lengths]
    tensors.append(engine.last_token)
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


@pytest.mark.parametrize("kw", [
    {}, {"kv_pages": 24, "kv_page_size": 4, "kv_dtype": "int8"},
    {"weights_dtype": "int8", "kv_pages": 24, "kv_page_size": 4},
    {"spec_k": 2}, {"tp": 2},
], ids=["dense", "paged_int8_kv", "int8_weights", "spec", "tp2"])
def test_held_equals_the_engines_own_tensors(params, kw):
    kw = dict(kw)
    if kw.pop("tp", 0):
        kw.update(world=comm.init({"model": 2}, devices=["cpu"]), tp_axis="model")
    if kw.get("spec_k"):
        kw["draft_params"], kw["draft_cfg"] = draft_from_target(params["torch"], TCFG, 1)
    eng = Engine(TCFG, params["torch"], device="cpu", **GEOM, **kw)
    assert eng.memledger.held() == _tensor_bytes(eng)
    if kw.get("spec_k"):  # the port's draft owns its weights
        assert eng.memledger.held("draft_weights") > 0


def _check_conserved(server):
    eng = server.engine
    ml = eng.memledger
    assert ml.conservation()["ok"]
    if eng.paged:
        assert ml.held("kv_pages") == eng.allocator.pages_in_use * eng.page_bytes
        assert ml.held("kv_cow_reserve") == eng.allocator.reserved * eng.page_bytes
    else:
        assert ml.held("kv_slots") == len(server.live) * eng.slot_bytes
    if eng.host_pages:
        assert ml.held("kv_host_pages") == eng.allocator.host_pages_in_use * eng.page_bytes


def _stepwise(server, max_ticks=200):
    while server._pending() and server.tick < max_ticks:
        server._run_tick()
        _check_conserved(server)
    return {c.rid: c.tokens for c in server.completed}


@pytest.mark.parametrize("kw", [
    {}, {"kv_pages": 24, "kv_page_size": 4},
    {"kv_pages": 24, "kv_page_size": 4, "kv_host_pages": 12, "prefill_chunk": 4},
], ids=["dense", "paged_prefix_cow", "host_tier_preempt"])
def test_grants_minus_frees_equal_held_every_tick(params, kw):
    eng = Engine(TCFG, params["torch"], device="cpu", decode_attention="reference",
                 **GEOM, **kw)
    server = Server(eng, policy=SchedulingPolicy() if eng.host_pages else None)
    server.submit(Request(rid="a", prompt=SYSP + [20, 21], max_new_tokens=6, priority=1))
    server.submit(Request(rid="b", prompt=SYSP + [30], max_new_tokens=9, priority=1))
    for _ in range(3):
        server._run_tick()
        _check_conserved(server)
    if eng.host_pages:
        server._preempt(next(iter(server.live)))
        _check_conserved(server)
    server.submit(Request(rid="c", prompt=SYSP + [20, 21], max_new_tokens=5))
    done = _stepwise(server)
    assert set(done) == {"a", "b", "c"}
    eng.reset()
    assert eng.memledger.conservation()["ok"]
    assert eng.memledger.held() == _tensor_bytes(eng)


def _served_memory(pkg, params, kw):
    if pkg == "jax":
        eng = JEngine(JCFG, params["jax"], decode_attention="reference", **{**GEOM, **kw})
        server, req = JServer(eng), JRequest
    else:
        eng = Engine(TCFG, params["torch"], device="cpu", decode_attention="reference",
                     **{**GEOM, **kw})
        server, req = Server(eng), Request
    server.submit(req(rid="a", prompt=SYSP + [20, 21], max_new_tokens=6, tenant="t0"))
    server.submit(req(rid="b", prompt=SYSP + [30], max_new_tokens=9, tenant="t1"))
    server.submit(req(rid="c", prompt=[3, 4, 5, 6, 7, 8, 9], max_new_tokens=12))
    server.run(max_ticks=4)
    mid = server.stats()["memory"]
    server.run()
    return mid, server.stats()["memory"], eng


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 8, "kv_page_size": 4, "slots": 3}],
                         ids=["dense", "paged_exhausted"])
def test_served_memory_block_equals_jax(params, kw):
    *mine, eng = _served_memory("torch", params, kw)
    *ref, _ = _served_memory("jax", params, kw)
    trash = eng.page_bytes if eng.paged else 0
    mine = [copy.deepcopy(m) for m in mine]  # the blocks share their exhaustion dump
    for m, r in zip(mine, ref):
        for key in ("worker_id", "role"):
            assert m[key] == r[key]
        m["held_by_subsystem"]["kv_pool"] -= trash
        for key in ("held_bytes", "held_peak_bytes"):
            m[key] -= trash
        m.pop("reconciliation")
        r.pop("reconciliation")
        m["conservation"] = r["conservation"] = None
        if "exhaustion" in m:
            m["exhaustion"]["subsystems"]["kv_pool"] -= trash
            m["exhaustion"]["hbm_held_bytes"] -= trash
        assert m == r
    if kw:
        assert mine[0]["exhaustion"]["top_holders"]
    assert mine[0]["per_request"] and mine[0]["eviction_candidates"]
    assert eng.memledger.reconcile()["device_bytes"] is None
