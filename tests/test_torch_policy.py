"""mpit_tpu_torch's scheduling policy and preemption against the JAX
package's.

``serve/policy.py`` is a copy of :mod:`mpit_tpu.serve.policy`: spec
parsing, the tiers' deficit round robin, ``pick_victim`` and
``wants_preemption`` must decide as JAX's does on the same inputs. A
``Server(policy=...)`` over the same scripted submissions admits in JAX's
order with JAX's tokens. ``Server._preempt`` (driven directly, as JAX's
tests drive it, so nothing depends on tick timing) frees the same pages
as JAX's and leaves the allocator in the same state, and the resumed
request recomputes its way to the un-preempted run's tokens: f32 against
JAX, and bf16 and int8 pools, a speculative engine and a tensor-parallel
engine at ``model=2`` against the port's own un-preempted runs and JAX's.
Shed causes stay apart; the dense engine never preempts.

One module-scoped JAX engine (paged, f32, reference attention) serves
every JAX run here.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.obs.stream import StreamRegistry as JRegistry
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve import policy as jpol
from mpit_tpu_torch import comm, obs
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.obs.stream import StreamRegistry
from mpit_tpu_torch.serve import (
    Engine,
    Request,
    Server,
    draft_from_target,
    params_from_jax,
    policy as tpol,
)

JCFG = JConfig.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, d_model=64,
                    dtype=jnp.float32)
TCFG = GPT2Config.tiny(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2,
                       d_model=64, dtype=torch.float32)
GEOM = dict(slots=2, max_len=64, prefill_len=32, kv_pages=16, kv_page_size=8,
            prefill_chunk=8)


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
    """Every piece of the allocator's bookkeeping, as plain values."""
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
            "spilled_prefix_entries", "promoted_entries")},
    }


# -- spec parsing, the tiers, the verdicts (no engine) ----------------------

POLICY_SPECS = ["on", "default", "quantum=2,preempt=0,admission_factor=1.5,weight.t0=3,"
                "weight.t1=0.5", "max_preemptions=1,min_samples=2,projection_quantile=0.9,"
                "admission=false", " quantum=0.25 , admission=yes"]
BAD_POLICY_SPECS = ["quantum=0", "bogus=1", "quantum", "weight.t0=-1", "max_preemptions=-1",
                    "projection_quantile=0", "admission_factor=0", "min_samples=0"]


@pytest.mark.parametrize("text", POLICY_SPECS)
def test_parse_policy_spec_equal(text):
    assert dataclasses.asdict(tpol.parse_policy_spec(text)) == dataclasses.asdict(
        jpol.parse_policy_spec(text))


@pytest.mark.parametrize("text", BAD_POLICY_SPECS)
def test_parse_policy_spec_refusals_equal(text):
    with pytest.raises(ValueError) as want:
        jpol.parse_policy_spec(text)
    with pytest.raises(ValueError) as got:
        tpol.parse_policy_spec(text)
    assert str(got.value) == str(want.value)


@dataclasses.dataclass
class _L:
    """The fields of the scheduler's ``_Live`` the policy reads."""
    req: object
    submit_t: float = 0.0
    preempts: int = 0
    tokens: list = dataclasses.field(default_factory=list)


def _req(mod_request, rid, prompt, *, new=3, priority=0, tenant="", target=0.0):
    return mod_request(rid=rid, prompt=list(prompt), max_new_tokens=new, priority=priority,
                       tenant=tenant, ttft_target_s=target)


def _drr_script(mod, request_cls, cfg):
    """A script of enqueues, pops, failed admissions (``restore``) and
    preemption re-queues over three tiers and four tenants of unequal
    weight; returns every pop's rid and the tiers' deficits after it."""
    pol = mod.SchedulingPolicy(cfg)
    rng = np.random.RandomState(3)
    seq, held = [], deque()
    for step in range(160):
        op = rng.randint(0, 10)
        if op < 5:
            tenant = f"t{rng.randint(0, 4)}"
            pol.enqueue(_L(_req(request_cls, f"r{step}", [1], priority=int(rng.randint(0, 3)),
                                tenant=tenant), submit_t=float(step)))
        elif op < 8:
            item = pol.next()
            seq.append(None if item is None else item.req.rid)
            if item is not None:
                held.append(item)
        elif op == 8 and held:
            pol.restore(held.pop())
        elif held:
            pol.requeue_front(held.popleft())
        seq.append({p: dict(st.deficit) for p, st in pol._tiers.items()})
    while (item := pol.next()) is not None:
        seq.append(item.req.rid)
    return seq, list(pol.admitted), pol.tier_depths(), pol.stats()


@pytest.mark.parametrize("quantum,weights", [
    (4.0, {}), (1.0, {"t0": 3.0, "t1": 0.5}), (0.5, {"t2": 0.2, "t3": 2.0}),
], ids=["defaults", "weighted", "fractional"])
def test_drr_order_equal(quantum, weights):
    """Tier order, tenant deficit round robin, restore refunds and front
    re-queues: the same pops, deficits and admission log as JAX's."""
    want = _drr_script(jpol, JRequest, jpol.PolicyConfig(quantum=quantum,
                                                         tenant_weights=weights))
    got = _drr_script(tpol, Request, tpol.PolicyConfig(quantum=quantum,
                                                       tenant_weights=weights))
    assert got == want


def test_verdicts_equal():
    """``should_shed``, ``wants_preemption`` and ``pick_victim`` on
    windows fed the same tick costs, for the same queues and live set
    (the ``now`` given, so nothing depends on the clock)."""
    out = {}
    for name, mod, reg_cls, req_cls in (("jax", jpol, JRegistry, JRequest),
                                        ("torch", tpol, StreamRegistry, Request)):
        reg = reg_cls()
        for v in (0.010, 0.012, 0.011, 0.013):
            reg.observe("prefill_tick", v)
        reg.observe("decode_tick", 0.004)
        pol = mod.SchedulingPolicy(mod.PolicyConfig(max_preemptions=2), reg)
        verdicts = []
        for i, (prio, target) in enumerate([(0, 0.0), (0, 0.5), (0, 0.03), (1, 0.02)]):
            r = _req(req_cls, f"s{i}", [1], priority=prio, target=target)
            verdicts.append((pol.should_shed(r), dict(pol.last_admission)))
            pol.enqueue(_L(r, submit_t=1.0 + i))
        live = {s: _L(_req(req_cls, f"v{s}", [1], new=10, priority=p), preempts=n,
                      tokens=[0] * t)
                for s, (p, n, t) in enumerate([(1, 0, 3), (2, 0, 5), (2, 2, 1), (0, 0, 1)])}
        verdicts += [pol.wants_preemption(now) for now in (1.0, 1.05, 1.5)]
        verdicts.append(pol.last_preemption_for)
        verdicts += [pol.pick_victim(live, p) for p in (0, 1, 2)]
        out[name] = verdicts
    assert out["torch"] == out["jax"]
    assert True in [v[0] for v in out["torch"][:4]]  # the projection shed one


# -- the Server under a policy ----------------------------------------------

def _policy_run(pkg, engine, submissions, cfg_kw):
    mod = jpol if pkg == "jax" else tpol
    server = (JServer if pkg == "jax" else Server)(
        engine, policy=mod.SchedulingPolicy(mod.PolicyConfig(**cfg_kw)))
    req_cls = JRequest if pkg == "jax" else Request
    for rid, prompt, new, prio, tenant in submissions[:4]:
        assert server.submit(_req(req_cls, rid, prompt, new=new, priority=prio, tenant=tenant))
    server.run(max_ticks=3)
    for rid, prompt, new, prio, tenant in submissions[4:]:
        assert server.submit(_req(req_cls, rid, prompt, new=new, priority=prio, tenant=tenant))
    done = server.run()
    return ([c.rid for c in done], {c.rid: c.tokens for c in done},
            list(server.policy.admitted), server.stats()["policy"])


def test_server_policy_order_and_tokens_equal(params, jengine):
    """One scripted submit sequence over two tiers and three tenants
    (admission and preemption off, so no decision reads a clock): the
    admission log, the finish order and every token equal JAX's."""
    subs = [(f"r{i}", _prompt(i, 3 + 2 * (i % 4)), 2 + i % 3, int(i % 3 == 0), f"t{i % 3}")
            for i in range(9)]
    kw = dict(admission=False, preempt=False, quantum=1.0, tenant_weights={"t1": 2.0})
    jengine.reset()
    want = _policy_run("jax", jengine, subs, kw)
    got = _policy_run("torch", _tengine(params), subs, kw)
    assert got == want
    assert [a[1] for a in got[2][:2]] == [0, 0]  # tier 0 first


def _preempt_script(pkg, engine, prompt, new=8, ticks=6):
    """Park a lone priority-1 request mid-generation through
    ``Server._preempt`` and resume it. Returns its tokens, the allocator
    state right after the park, the pages the park freed and the
    server."""
    mod = jpol if pkg == "jax" else tpol
    server = (JServer if pkg == "jax" else Server)(engine, policy=mod.SchedulingPolicy())
    server.submit(_req(JRequest if pkg == "jax" else Request, "v", prompt, new=new,
                       priority=1))
    server.run(max_ticks=ticks)
    slot = next(iter(server.live))
    assert 0 < len(server.live[slot].tokens) < new
    free0 = len(engine.allocator.free)
    server._preempt(slot)
    parked = _alloc_state(engine.allocator)
    freed = len(engine.allocator.free) - free0
    done = server.run()
    return done[0].tokens, parked, freed, server


def _plain_tokens(server_cls, request_cls, engine, reqs):
    server = server_cls(engine)
    for rid, prompt, new in reqs:
        server.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=new))
    return {c.rid: c.tokens for c in server.run()}


@pytest.fixture(scope="module")
def jax_runs(params, jengine):
    """JAX's runs every comparison below reads, each once."""
    prompt = _prompt(7, 10)
    jengine.reset()
    ref = _plain_tokens(JServer, JRequest, jengine, [("v", prompt, 8)])["v"]
    jengine.reset()
    tokens, parked, freed, server = _preempt_script("jax", jengine, prompt)
    return {"prompt": prompt, "ref": ref, "tokens": tokens, "parked": parked,
            "freed": freed, "policy": server.stats()["policy"],
            "final": _alloc_state(jengine.allocator)}


def test_preempt_resume_recompute_equals_jax(params, jax_runs):
    """f32: the park frees JAX's page count and leaves JAX's allocator
    state; the recompute resume gives JAX's tokens, which are the
    un-preempted run's."""
    tokens, parked, freed, server = _preempt_script("torch", _tengine(params),
                                                    jax_runs["prompt"])
    assert freed == jax_runs["freed"] > 0
    assert parked == jax_runs["parked"]
    assert tokens == jax_runs["tokens"] == jax_runs["ref"]
    assert _alloc_state(server.engine.allocator) == jax_runs["final"]
    st = server.stats()
    assert st["policy"] == jax_runs["policy"]
    assert st["preemptions"] == 1 and st["policy"]["resumes"] == 1
    assert len(server.resume_durations["recompute"]) == 1
    assert "resume_recompute_p95_s" in st


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_preempt_resume_recompute_quantized_pools(params, jax_runs, kv_dtype):
    """bf16 and int8 pools: the resumed request's tokens equal the same
    engine's un-preempted run."""
    engine = _tengine(params, kv_dtype=kv_dtype)
    ref = _plain_tokens(Server, Request, engine, [("v", jax_runs["prompt"], 8)])["v"]
    engine.reset()
    tokens, _, freed, _ = _preempt_script("torch", engine, jax_runs["prompt"])
    assert tokens == ref and freed == jax_runs["freed"]


def test_preempt_resume_speculative(params, jax_runs):
    """A speculative engine (k 2, the first layer as the draft; the draft
    pool rides the same block tables) parked mid-generation and resumed:
    greedy tokens equal JAX's plain un-preempted run."""
    dstate, dcfg = draft_from_target(params["torch"], TCFG, 1)
    engine = _tengine(params, spec_k=2, draft_params=dstate, draft_cfg=dcfg)
    tokens, _, _, server = _preempt_script("torch", engine, jax_runs["prompt"], ticks=4)
    assert tokens == jax_runs["ref"]
    assert server.stats()["spec_drafted_tokens"] > 0


def test_preempt_resume_tensor_parallel(params, jax_runs):
    """A tensor-parallel engine at ``model=2`` (head-sharded pool) parked
    and resumed: JAX's un-preempted tokens."""
    engine = _tengine(params, world=comm.init({"model": 2}, devices=["cpu"]),
                      tp_axis="model")
    tokens, _, freed, _ = _preempt_script("torch", engine, jax_runs["prompt"])
    assert tokens == jax_runs["ref"] and freed == jax_runs["freed"]


def test_preemption_frees_exactly_nonshared_pages(params, jengine):
    """Parking the sharer of a prefix frees its sole-owner pages and only
    drops a refcount on the shared ones, as JAX's does; both finish with
    JAX's tokens."""
    prefix = _prompt(11, 16)
    out = {}
    for pkg in ("jax", "torch"):
        engine = jengine if pkg == "jax" else _tengine(params)
        if pkg == "jax":
            engine.reset()
        mod = jpol if pkg == "jax" else tpol
        req_cls = JRequest if pkg == "jax" else Request
        server = (JServer if pkg == "jax" else Server)(engine, policy=mod.SchedulingPolicy())
        server.submit(_req(req_cls, "a", prefix + [1, 2], new=10, priority=1))
        server.run(max_ticks=5)
        server.submit(_req(req_cls, "b", prefix + [3, 4], new=10, priority=1))
        server.run(max_ticks=10)
        alloc = engine.allocator
        owned, shared = alloc.slot_page_stats(1)
        free0, ref0 = len(alloc.free), alloc.refcount.copy()
        server._preempt(1)
        dropped = ref0 - alloc.refcount
        out[pkg] = (owned, shared, len(alloc.free) - free0, dropped.tolist(),
                    {c.rid: c.tokens for c in server.run()})
    assert out["torch"] == out["jax"]
    owned, shared, freed, _, done = out["torch"]
    assert shared > 0 and freed == owned and set(done) == {"a", "b"}


def test_policy_triggers_preemption_for_interactive(params):
    """Long priority-1 generations fill both slots; an interactive arrival
    whose TTFT target (0.1 ms) any tick on any host exceeds makes the
    policy preempt one (the decision is the policy's, not the test's),
    it finishes before a victim, and every request's tokens equal its
    run alone."""
    engine = _tengine(params, kv_pages=20)
    prompts = {"long0": _prompt(20, 8), "long1": _prompt(21, 8), "hi": _prompt(22, 4)}
    news = {"long0": 20, "long1": 20, "hi": 3}
    refs = {}
    for rid, p in prompts.items():
        engine.reset()
        refs[rid] = _plain_tokens(Server, Request, engine, [(rid, p, news[rid])])[rid]
    engine.reset()
    rec = obs.Recorder()
    with obs.local_recorder(rec):
        pol = tpol.SchedulingPolicy(tpol.PolicyConfig(min_samples=1, admission=False))
        server = Server(engine, policy=pol)
        for rid in ("long0", "long1"):
            server.submit(_req(Request, rid, prompts[rid], new=20, priority=1))
        server.run(max_ticks=8)
        assert len(server.live) == 2
        server.submit(_req(Request, "hi", prompts["hi"], new=3, priority=0, target=1e-4))
        done = server.run()
    assert pol.preemptions >= 1 and pol.resumes == pol.preemptions
    by_rid = {c.rid: c for c in done}
    assert {rid: c.tokens for rid, c in by_rid.items()} == refs
    assert by_rid["hi"].finish_t < max(by_rid["long0"].finish_t, by_rid["long1"].finish_t)
    names = [e[1] for e in rec.snapshot()["events"]]
    assert "request_preempted" in names and "request_resumed" in names


def test_dense_engine_never_preempts(params):
    """No pages to free: a starving interactive head preempts nothing."""
    engine = Engine(TCFG, params["torch"], device="cpu", slots=1, max_len=48, prefill_len=16)
    pol = tpol.SchedulingPolicy(tpol.PolicyConfig(min_samples=1, admission=False))
    server = Server(engine, policy=pol)
    server.submit(_req(Request, "long", [1] * 4, new=12, priority=1))
    server.run(max_ticks=4)
    server.submit(_req(Request, "hi", [2] * 3, new=2, priority=0, target=1e-6))
    done = server.run()
    assert pol.preemptions == 0 and {c.rid for c in done} == {"long", "hi"}


def test_shed_causes_kept_apart_equal(params, jengine):
    """``max_queue`` sheds (``queue_full``) and the projection's verdict
    (``admission``) counted apart, with the same verdicts, counts and
    stats as JAX's for one script; the admitted ones complete."""
    out = {}
    for pkg in ("jax", "torch"):
        engine = jengine if pkg == "jax" else _tengine(params)
        if pkg == "jax":
            engine.reset()
        mod, reg_cls, req_cls = ((jpol, JRegistry, JRequest) if pkg == "jax"
                                 else (tpol, StreamRegistry, Request))
        reg = reg_cls()
        for v in (0.01, 0.01, 0.01, 0.01):
            reg.observe("prefill_tick", v)
        server = (JServer if pkg == "jax" else Server)(
            engine, stream=reg, max_queue=3, policy=mod.SchedulingPolicy(registry=reg))
        verdicts = [server.submit(_req(req_cls, f"r{i}", [1, 2, 3], new=2, target=t,
                                       tenant="t0" if i % 2 else "t1"))
                    for i, t in enumerate([0.0, 1.0, 0.001, 0.0, 5.0, 0.0])]
        server.run()
        st = server.stats()
        out[pkg] = (verdicts, [r.rid for r in server.shed], dict(server.shed_causes),
                    st["requests_shed"], st["policy"]["shed_admission"],
                    sorted(c.rid for c in server.completed), st["tenants"])
    assert out["torch"][:-1] == out["jax"][:-1]
    assert {t: {k: v for k, v in e.items() if k != "ttft_p95_s"}
            for t, e in out["torch"][-1].items()} == {
        t: {k: v for k, v in e.items() if k != "ttft_p95_s"}
        for t, e in out["jax"][-1].items()}
    assert out["torch"][2] == {"admission": 1, "queue_full": 2}


def test_priority_validation(params):
    server = Server(_tengine(params))
    with pytest.raises(ValueError, match="priority must be >= 0"):
        server.submit(Request(rid="x", prompt=[1], priority=-1))
