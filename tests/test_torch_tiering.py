"""mpit_tpu_torch's host KV tier against the JAX package's.

The allocator's host half is host bookkeeping and must equal
:mod:`mpit_tpu.serve.kvcache`'s bit for bit: driven through one seeded
script of admissions, registrations, copy-on-write, parks, spills,
frees and takes, both allocators return the same plans and hold the
same free list, refcounts, seats, parked records and prefix index after
every step, including the cold-entry eviction order. Through the
``Server``: a victim parked with ``Server._preempt`` (driven directly,
so no decision reads a clock) spills, resumes by restreaming and gives
JAX's tokens, which are the un-preempted run's; a resume whose parked
boundary page is still shared copies it out first; a retiring
request's prefix entries migrate to the host and serve a later hit by
restream. bf16 and int8 pools, a speculative engine and a
tensor-parallel engine at ``model=2`` resume to the same tokens. The
engine's spill and restore move the whole page (every layer, K and V,
scales, every rank's heads, the draft pool).

One module-scoped JAX engine (paged, f32, reference attention, three
host pages) serves every JAX run here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import SchedulingPolicy as JPolicy
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve.kvcache import PageAllocator as JAllocator
from mpit_tpu_torch import comm
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.ops.kv_quant import kv_tensors
from mpit_tpu_torch.serve import (
    Engine,
    PageAllocator,
    Request,
    SchedulingPolicy,
    Server,
    draft_from_target,
    params_from_jax,
    warm_engine,
)

JCFG = JConfig.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                    dtype=jnp.float32)
TCFG = GPT2Config.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2,
                       d_model=64, dtype=torch.float32)
GEOM = dict(slots=2, max_len=64, prefill_len=32, kv_pages=16, kv_page_size=8,
            prefill_chunk=8, kv_host_pages=3)


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


@pytest.fixture(scope="module")
def jengine(params):
    return JEngine(JCFG, jax.tree.map(jnp.asarray, params["jax"]),
                   decode_attention="reference", **GEOM)


def _tengine(params, **kw):
    return Engine(TCFG, params["torch"], device="cpu", **{**GEOM, **kw})


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, JCFG.vocab_size, size=n).tolist()


def _alloc_state(a) -> dict:
    return {
        "free": list(a.free),
        "refcount": a.refcount.tolist(),
        "block_tables": a.block_tables.tolist(),
        "reserved": a.reserved,
        "cow_reserve": dict(a._cow_reserve),
        "slot_pages": {k: list(v) for k, v in a._slot_pages.items()},
        "index": {k: (e.tokens, tuple(e.pages), e.tier) for k, e in a._index.items()},
        "page_keys": {k: set(v) for k, v in a._page_keys.items() if v},
        "prefix_touch": dict(a._prefix_touch),
        "host_free": list(a.host_free),
        "host_page_keys": {k: set(v) for k, v in a._host_page_keys.items()},
        "parked": {k: (tuple(v.host_pages), v.fill) for k, v in a._parked.items()},
        **{n: getattr(a, n) for n in (
            "cow_copies", "prefix_hits", "admissions", "shared_tokens_total",
            "prompt_tokens_total", "host_prefix_hits", "parked_spills",
            "spilled_prefix_entries", "promoted_entries", "host_pages_in_use",
            "host_resident_entries", "free_pages", "pages_in_use")},
    }


def _plan(p):
    return None if p is None else (p.shared_tokens, tuple(p.pages), tuple(p.restream))


def _allocator_script(cls, seed, host_pages):
    """A seeded script over one allocator: admissions from a few shared
    prefixes, registrations, COW probes, parks and prefix spills before
    frees, takes and drops. Returns every call's result and the state
    after it."""
    rng = np.random.RandomState(seed)
    a = cls(24, 4, 8, 3, host_pages=host_pages)
    stems = [rng.randint(0, 50, size=n).tolist() for n in (6, 9, 13)]
    live: dict[int, tuple] = {}
    parked: list = []
    log = []
    for tick in range(90):
        op = rng.randint(0, 6)
        free_slots = [s for s in range(3) if s not in live]
        if op <= 1 and free_slots:
            slot = free_slots[0]
            prompt = stems[rng.randint(0, 3)][: rng.randint(3, 14)] + rng.randint(
                0, 50, size=rng.randint(0, 4)).tolist()
            prompt = prompt or [1]
            new = int(rng.randint(1, 12))
            out = _plan(a.admit(slot, prompt, new, tick=tick))
            if out is not None:
                live[slot] = (f"r{tick}", prompt, new)
        elif op == 2 and live:
            slot = sorted(live)[rng.randint(0, len(live))]
            prompt = live[slot][1]
            out = (a.cow_before_write(slot, int(rng.randint(0, len(prompt)))),
                   a.register_prefix(slot, prompt, tick=tick))
        elif op == 3 and live:
            slot = sorted(live)[rng.randint(0, len(live))]
            rid, prompt, new = live.pop(slot)
            fill = len(prompt) + int(rng.randint(0, new))
            park = a.park_pages(rid, slot, fill)
            out = (park, a.spill_prefix_on_free(slot), a.slot_page_stats(slot))
            a.free_slot(slot)
            if park is not None:
                parked.append(rid)
        elif op == 4 and live:
            slot = sorted(live)[rng.randint(0, len(live))]
            live.pop(slot)
            out = (a.spill_prefix_on_free(slot), a.free_slot(slot))
        elif op == 5 and parked:
            rid = parked.pop(rng.randint(0, len(parked)))
            rec = a.peek_parked(rid)
            got = (a.take_parked(rid) if rng.randint(0, 2) else a.drop_parked(rid))
            out = ((tuple(rec.host_pages), rec.fill),
                   got if isinstance(got, list) else (tuple(got.host_pages), got.fill))
        else:
            out = None
        log.append((op, out, _alloc_state(a)))
    return log


@pytest.mark.parametrize("seed,host_pages", [(0, 4), (1, 9), (2, 2), (3, 16)])
def test_allocator_host_tier_bit_equal(seed, host_pages):
    """Every plan, spill list, eviction and the whole state after each
    step equal JAX's allocator's."""
    want = _allocator_script(JAllocator, seed, host_pages)
    got = _allocator_script(PageAllocator, seed, host_pages)
    assert got == want
    assert any(s["parked_spills"] for _, _, s in got)


def test_allocator_reclaims_coldest_host_entry_first():
    """Two prompts' entries on the host, the older touched again by a hit:
    a park that needs seats evicts the colder prompt's, as JAX's does."""
    out = []
    for cls in (JAllocator, PageAllocator):
        a = cls(16, 4, 4, 2, host_pages=6)
        for slot, (prompt, tick) in enumerate([([1, 2, 3, 4, 5, 6, 7, 8], 1),
                                               ([9, 10, 11, 12, 13], 2)]):
            a.admit(slot, prompt, 2, tick=tick)
            a.register_prefix(slot, prompt, tick=tick)
            a.spill_prefix_on_free(slot)
            a.free_slot(slot)
        plan = a.admit(0, [1, 2, 3, 4, 5, 6, 7, 8, 20], 2, tick=5)  # a host hit, refreshed
        parked = a.park_pages("v", 0, 9)
        out.append((_plan(plan), parked, _alloc_state(a)))
    assert out[1] == out[0]
    assert out[1][1][1] == [2, 3]  # the colder prompt's seats went
    index = out[1][2]["index"]
    assert [e for e in index.values() if e[0] == (9, 10, 11, 12, 13)] == []
    assert any(e[0] == (1, 2, 3, 4, 5, 6, 7, 8) and e[2] == "host" for e in index.values())


def _restream_script(pkg, engine, prompt, new=8, ticks=6):
    """Park a lone priority-1 request mid-generation and resume it."""
    server = (JServer if pkg == "jax" else Server)(
        engine, policy=(JPolicy if pkg == "jax" else SchedulingPolicy)())
    server.submit((JRequest if pkg == "jax" else Request)(
        rid="v", prompt=prompt, max_new_tokens=new, priority=1))
    server.run(max_ticks=ticks)
    slot = next(iter(server.live))
    assert 0 < len(server.live[slot].tokens) < new
    server._preempt(slot)
    parked = _alloc_state(engine.allocator)
    assert engine.allocator.peek_parked("v") is not None
    done = server.run()
    return done[0].tokens, parked, server


def _plain_tokens(server_cls, request_cls, engine, reqs):
    server = server_cls(engine)
    for rid, prompt, new in reqs:
        server.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=new))
    return {c.rid: c.tokens for c in server.run()}


HOST_KEYS = ("kv_host_pages", "host_spilled_pages", "host_restreamed_pages",
             "host_prefix_hits", "parked_spills", "spilled_prefix_entries",
             "promoted_entries", "kv_host_pages_in_use", "preemptions")


@pytest.fixture(scope="module")
def jax_restream(params, jengine):
    prompt = _prompt(7, 10)
    jengine.reset()
    ref = _plain_tokens(JServer, JRequest, jengine, [("v", prompt, 8)])["v"]
    jengine.reset()
    tokens, parked, server = _restream_script("jax", jengine, prompt)
    st = server.stats()
    return {"prompt": prompt, "ref": ref, "tokens": tokens, "parked": parked,
            "stats": {k: st[k] for k in HOST_KEYS},
            "final": _alloc_state(jengine.allocator)}


def test_restream_resume_equals_jax(params, jax_restream):
    """f32: the park spills JAX's pages into JAX's seats, the resume
    restreams (not recomputes) and gives JAX's tokens, the un-preempted
    run's; counters and the final allocator state equal JAX's."""
    engine = _tengine(params)
    tokens, parked, server = _restream_script("torch", engine, jax_restream["prompt"])
    assert parked == jax_restream["parked"]
    assert tokens == jax_restream["tokens"] == jax_restream["ref"]
    st = server.stats()
    assert {k: st[k] for k in HOST_KEYS} == jax_restream["stats"]
    assert _alloc_state(engine.allocator) == jax_restream["final"]
    assert st["host_restreamed_pages"] > 0 and st["parked_spills"] == 1
    assert len(server.resume_durations["restream"]) == 1
    assert not server.resume_durations["recompute"] and "resume_restream_p95_s" in st
    assert st["host_spill_bytes"] == st["host_spilled_pages"] * engine.page_bytes
    assert st["host_restream_bytes"] == st["host_restreamed_pages"] * engine.page_bytes


@pytest.mark.parametrize("kw", [{"kv_dtype": "bf16"}, {"kv_dtype": "int8"},
                                {"spec_k": 2}, {"tp": 2}], ids=["bf16", "int8", "spec", "tp2"])
def test_restream_resume_forms(params, jax_restream, kw):
    """bf16 and int8 pools (the int8 rows and their scales travel as one
    page), a speculative engine (the draft pool's page too) and a
    tensor-parallel engine at model=2 (every rank's heads): the restream
    resume gives the same engine's un-preempted tokens, and in f32 JAX's."""
    kw = dict(kw)
    if kw.pop("tp", 0):
        kw.update(world=comm.init({"model": 2}, devices=["cpu"]), tp_axis="model")
    if kw.get("spec_k"):
        kw["draft_params"], kw["draft_cfg"] = draft_from_target(params["torch"], TCFG, 1)
    engine = _tengine(params, **kw)
    ref = _plain_tokens(Server, Request, engine, [("v", jax_restream["prompt"], 8)])["v"]
    engine.reset()
    tokens, _, server = _restream_script("torch", engine, jax_restream["prompt"],
                                         ticks=4 if "spec_k" in kw else 6)
    assert tokens == ref
    if "kv_dtype" not in kw:
        assert tokens == jax_restream["ref"]
    assert server.resume_durations["restream"] and server.stats()["host_restreamed_pages"]


def _cow_boundary(pkg, engine):
    """A victim whose parked boundary page is shared again at resume: the
    prefix (10 tokens, ending mid-page) is a live request's. Three host
    seats: the park (two pages) fits, the victim's own prompt entry does
    not, so the resume shares the live prefix partly."""
    req_cls = JRequest if pkg == "jax" else Request
    prefix = _prompt(13, 10)
    req_a = req_cls(rid="a", prompt=prefix, max_new_tokens=20, priority=1)
    req_b = req_cls(rid="b", prompt=prefix + [3, 4], max_new_tokens=8, priority=1)
    server = (JServer if pkg == "jax" else Server)(
        engine, policy=(JPolicy if pkg == "jax" else SchedulingPolicy)())
    server.submit(req_a)
    server.run(max_ticks=5)
    server.submit(req_b)
    server.run(max_ticks=7)
    slot_b = next(s for s, live in server.live.items() if live.req.rid == "b")
    cows = engine.allocator.cow_copies
    server._preempt(slot_b)
    parked = _alloc_state(engine.allocator)
    done = {c.rid: c.tokens for c in server.run()}
    return (done, parked, engine.allocator.cow_copies - cows,
            len(server.resume_durations["restream"]), _alloc_state(engine.allocator))


def test_restream_through_cow_shared_boundary_equals_jax(params, jengine):
    jengine.reset()
    want = _cow_boundary("jax", jengine)
    got = _cow_boundary("torch", _tengine(params))
    assert got == want
    done, parked, cows, restreams, _ = got
    assert parked["parked"] and parked["host_resident_entries"] == 0
    assert cows >= 1 and restreams == 1
    jengine.reset()
    ref = _plain_tokens(JServer, JRequest, jengine,
                        [("a", _prompt(13, 10), 20), ("b", _prompt(13, 10) + [3, 4], 8)])
    assert done == ref


def _prefix_survival(pkg, engine):
    """``a`` retires: its prefix entries migrate to the host; ``b``
    shares the prefix and is served by a host hit, restored into its
    fresh pages, and its registration promotes the entries back."""
    req_cls = JRequest if pkg == "jax" else Request
    prefix = _prompt(17, 16)
    server = (JServer if pkg == "jax" else Server)(engine)
    server.submit(req_cls(rid="a", prompt=prefix + [1, 2], max_new_tokens=4))
    server.run()
    after_a = _alloc_state(engine.allocator)
    server.submit(req_cls(rid="b", prompt=prefix + [3, 4], max_new_tokens=6))
    done = {c.rid: c.tokens for c in server.run()}
    st = server.stats()
    return done, after_a, {k: st[k] for k in HOST_KEYS if k != "preemptions"}, _alloc_state(
        engine.allocator)


def test_prefix_entry_survives_reclaim_serves_restream_hit(params, jengine):
    jengine.reset()
    want = _prefix_survival("jax", jengine)
    got = _prefix_survival("torch", _tengine(params))
    assert got == want
    done, after_a, st, _ = got
    assert after_a["host_resident_entries"] > 0 and st["host_prefix_hits"] == 1
    assert st["host_restreamed_pages"] > 0 and st["promoted_entries"] > 0
    jengine.reset()
    ref = _plain_tokens(JServer, JRequest, jengine, [("b", _prompt(17, 16) + [3, 4], 6)])
    assert done["b"] == ref["b"]


def test_host_tier_keeps_prefix_hits_under_pressure(params):
    """Serialized requests behind one 16-token prefix: without the tier
    the entry dies at every retirement; with it every later request hits."""
    prefix = _prompt(23, 16)
    rng = np.random.RandomState(23)
    trace = [(f"r{i}", prefix + rng.randint(0, 128, size=4).tolist(), 4) for i in range(6)]
    stats = {}
    for host in (3, 0):
        engine = _tengine(params, kv_host_pages=host)
        server = Server(engine)
        for rid, prompt, new in trace:
            server.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
            server.run()
        stats[host] = server.stats()
    assert stats[3]["host_prefix_hits"] == 5
    assert stats[3]["prefix_hit_rate"] > stats[0]["prefix_hit_rate"]


def _page_bytes_of(engine, page):
    return [v.clone() for v in engine._page_views(page)]


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"}, {"kv_dtype": "bf16", "spec_k": 2},
                                {"tp": 2}], ids=["f32", "int8", "bf16_spec", "tp2"])
def test_spill_restore_moves_the_whole_page(params, kw):
    """Spill a written page, overwrite it, restore it: every tensor the
    page spans is back bit for bit; ``page_bytes`` counts all of them
    and the counters count pages and bytes."""
    kw = dict(kw)
    if kw.pop("tp", 0):
        kw.update(world=comm.init({"model": 2}, devices=["cpu"]), tp_axis="model")
    if kw.get("spec_k"):
        kw["draft_params"], kw["draft_cfg"] = draft_from_target(params["torch"], TCFG, 1)
    engine = _tengine(params, **kw)
    server = Server(engine)
    server.submit(Request(rid=0, prompt=_prompt(3, 12), max_new_tokens=10))
    server.run(max_ticks=3)  # the prompt is cached, the request still live
    page = int(engine.allocator.block_tables[0, 0])
    before = _page_bytes_of(engine, page)
    views = engine._page_views(page)
    assert engine.page_bytes == sum(v.numel() * v.element_size() for v in views)
    assert len(views) == (2 if "kv_dtype" not in kw or kw["kv_dtype"] != "int8" else 4) * (
        2 if "spec_k" in kw else 1)
    engine.spill_page(page, 2)
    for v in views:
        v.fill_(7)
    assert engine.drain_spills() == 0  # on the CPU the copy lands at once
    engine.restore_page(2, page, release=True)
    assert all(torch.equal(a, b) for a, b in zip(_page_bytes_of(engine, page), before))
    assert (engine.host_spilled_pages, engine.host_restreamed_pages) == (1, 1)
    assert engine.host_spill_bytes == engine.host_restream_bytes == engine.page_bytes
    with pytest.raises(KeyError, match="no payload"):
        engine.restore_page(2, page)  # released
    engine.spill_page(page, 1)
    engine.host_free(1)
    with pytest.raises(KeyError, match="no payload"):
        engine.restore_page(1, page)
    engine.reset()
    assert engine.host_spilled_pages == 0 and engine.allocator.host_pages_in_use == 0


def test_page_bytes_of_gpt2_small_pages():
    """GPT-2 small's 16-token page, from the shapes alone: 12 layers x K
    and V x 16 rows x 12 heads x 64 in bf16 is 589,824 bytes; int8 rows
    and f32 scales 313,344."""
    cfg = GPT2Config.small()
    from mpit_tpu_torch.serve.kvcache import alloc_paged_cache

    for kv_dtype, want in ((torch.bfloat16, 589_824), (None, 313_344)):
        pool = alloc_paged_cache(cfg, 1, 1, 16, device="cpu", dtype=kv_dtype,
                                 quantized=kv_dtype is None)
        got = sum(b[pool.at(0)].numel() * b.element_size()
                  for b in kv_tensors(pool.k) + kv_tensors(pool.v))
        assert got == want


def test_warm_engine_round_trips_the_tier(params):
    engine = _tengine(params)
    warm_engine(engine)
    assert engine.host_spilled_pages == 0 and engine.allocator.host_pages_in_use == 0
    assert engine.allocator.admissions == 0


def test_host_tier_refusals(params):
    with pytest.raises(ValueError, match="paged engine's host KV tier"):
        Engine(TCFG, params["torch"], device="cpu", slots=2, max_len=64, kv_host_pages=4)
    with pytest.raises(ValueError, match="kv_host_pages must be >= 0"):
        _tengine(params, kv_host_pages=-1)
    plain = _tengine(params, kv_host_pages=0)
    assert plain.host_pages == 0 and plain.page_bytes > 0
    for call in (lambda: plain.spill_page(0, 0), lambda: plain.restore_page(0, 0),
                 lambda: plain.host_free(0)):
        with pytest.raises(ValueError, match="kv_host_pages"):
            call()
    assert plain.drain_spills() == 0
    with pytest.raises(ValueError, match="host_pages must be >= 0"):
        PageAllocator(4, 4, 4, 1, host_pages=-1)
