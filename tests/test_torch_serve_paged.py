"""mpit_tpu_torch's paged and int8 serving against the JAX package's.

The JAX package's ``Server`` over its paged engine (reference attention,
which keeps CPU time low) and the port's, on the same converted weights,
must give identical greedy tokens in each case of
``tests/test_serve.py``'s ``TestPagedServing``: the staggered stream,
chunked prefill interleaving decode, prefix sharing with COW divergence,
full-prompt reuse with COW at decode, freed-page isolation, and pool
exhaustion that queues and then completes; the allocator counters JAX's
tests pin must be equal too. The never-fitting request and the engine's
validation raise as in JAX. Streams with ``kv_dtype`` f32, bf16 (cache
storage below the f32 model) and int8, dense and paged, match JAX's
engines with the same ``kv_dtype``.
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
from mpit_tpu.serve import Server as JServer
from mpit_tpu_torch import obs
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.serve import Engine, Request, Server, params_from_jax

JCFG = JConfig.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=jnp.float32,
)
TCFG = GPT2Config.tiny(
    vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
    dtype=torch.float32,
)
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
MAX_NEW = [6, 4, 8, 3, 5, 7]
PAGED = dict(slots=2, max_len=40, prefill_len=8, kv_pages=24, kv_page_size=4)
SYSP = [11, 12, 13, 14, 15]
COUNTERS = ("prefix_hits", "cow_copies", "shared_tokens_total", "pages_in_use")


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "torch": params_from_jax(p)}


def _engine(pkg, params, mode="kernel", **kw):
    if pkg == "jax":
        return JEngine(JCFG, params["jax"], decode_attention="reference", **kw)
    return Engine(TCFG, params["torch"], device="cpu", decode_attention=mode, **kw)


def _server(pkg, engine):
    return (JServer if pkg == "jax" else Server)(engine)


def _req(pkg, rid, prompt, n):
    return (JRequest if pkg == "jax" else Request)(
        rid=rid, prompt=prompt, max_new_tokens=n
    )


def _counters(engine):
    a = engine.allocator
    return {name: getattr(a, name) for name in COUNTERS} if a is not None else {}


# Each scenario drives one package's engine and returns (tokens by rid,
# allocator counters, server stats).


def _staggered(pkg, params, mode="kernel", **kw):
    engine = _engine(pkg, params, mode, **{**PAGED, **kw})
    server = _server(pkg, engine)
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(_req(pkg, i, p, n))
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


def _chunked(pkg, params):
    engine = _engine(pkg, params, **PAGED, prefill_chunk=2)
    server = _server(pkg, engine)
    server.submit(_req(pkg, "live", [5], 10))
    server.submit(_req(pkg, "long", [60, 2, 2, 1, 9, 9], 4))
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


def _prefix_cow(pkg, params):
    engine = _engine(pkg, params, **{**PAGED, "prefill_len": 16})
    server = _server(pkg, engine)
    server.submit(_req(pkg, "a", SYSP + [20, 21], 3))
    server.submit(_req(pkg, "b", SYSP + [30], 14))  # stays live throughout
    server.submit(_req(pkg, "c", SYSP + [20, 21], 6))
    server.submit(_req(pkg, "d", SYSP + [30, 31, 32, 33], 4))  # extends b
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


def _full_reuse(pkg, params):
    engine = _engine(pkg, params, **{**PAGED, "prefill_len": 16})
    server = _server(pkg, engine)
    p = [11, 12, 13, 14, 15, 16]  # one full page + one partial
    server.submit(_req(pkg, "a", p, 12))
    server.run(max_ticks=2)  # a's prefix is registered before b arrives
    server.submit(_req(pkg, "b", p, 5))
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


def _isolation(pkg, params):
    engine = _engine(
        pkg, params, slots=1, max_len=24, prefill_len=8, kv_pages=6,
        kv_page_size=4,
    )
    server = _server(pkg, engine)
    server.submit(_req(pkg, "a", [9, 9], 4))
    server.submit(_req(pkg, "mid", [1, 2, 3, 4, 5, 6, 7], 12))
    server.submit(_req(pkg, "b", [9, 9], 4))
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


def _exhaustion(pkg, params):
    engine = _engine(pkg, params, **{**PAGED, "slots": 4, "kv_pages": 6})
    server = _server(pkg, engine)
    for i in range(5):
        server.submit(_req(pkg, i, [1 + i, 2, 3], 6))
    done = {c.rid: c.tokens for c in server.run()}
    return done, _counters(engine), server.stats()


SCENARIOS = {
    "staggered": _staggered,
    "chunked": _chunked,
    "prefix_cow": _prefix_cow,
    "full_reuse": _full_reuse,
    "isolation": _isolation,
    "exhaustion": _exhaustion,
    "int8_dense": lambda pkg, params: _staggered(
        pkg, params, kv_pages=None, kv_page_size=16, prefill_len=16,
        kv_dtype="int8",
    ),
    "int8_paged": lambda pkg, params: _staggered(pkg, params, kv_dtype="int8"),
    "bf16_cache_paged": lambda pkg, params: _staggered(pkg, params, kv_dtype="bf16"),
    "f32_cache_paged": lambda pkg, params: _staggered(pkg, params, kv_dtype="f32"),
}


@pytest.fixture(scope="module")
def jax_runs(params):
    """Every scenario through the JAX package, once."""
    return {name: fn("jax", params) for name, fn in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_tokens_and_counters_equal_jax(params, jax_runs, name):
    done, counters, stats = SCENARIOS[name]("torch", params)
    j_done, j_counters, j_stats = jax_runs[name]
    assert done == j_done
    assert counters == j_counters
    for key in ("admissions", "concurrency_peak", "requests_completed",
                "generated_tokens", "kv_dtype", "kv_cow_copies", "prefix_hits"):
        assert stats.get(key) == j_stats.get(key), key


def test_staggered_reference_mode_equals_jax(params, jax_runs):
    """The port's reference engine (plain paged attention, dense
    sampling) gives the JAX server's tokens too, and the pool drains."""
    done, counters, _ = _staggered("torch", params, mode="reference")
    assert done == jax_runs["staggered"][0]
    assert counters["pages_in_use"] == 0


def test_scenarios_exercise_what_they_name(jax_runs):
    """The cases are not vacuous: sharing, COW and waiting on pages
    really happened (the JAX package's own pins)."""
    _, c, _ = jax_runs["prefix_cow"]
    assert c["prefix_hits"] >= 1 and c["cow_copies"] >= 1
    assert c["shared_tokens_total"] >= 6
    done, c, _ = jax_runs["full_reuse"]
    assert c["shared_tokens_total"] == 6 and c["cow_copies"] >= 1
    assert done["b"] == done["a"][:5]
    done, _, _ = jax_runs["isolation"]
    assert done["a"] == done["b"]
    assert jax_runs["exhaustion"][2]["concurrency_peak"] == 3


def test_chunked_prefill_interleaves_decode(params):
    """prefill_chunk=2: the 6-token prompt takes 3 chunk ticks while the
    live slot keeps decoding (9 decode ticks for its 10 tokens)."""
    rec = obs.enable(obs.Recorder())
    try:
        engine = _engine("torch", params, **PAGED, prefill_chunk=2)
        server = Server(engine)
        server.submit(Request(rid="live", prompt=[5], max_new_tokens=10))
        server.submit(Request(rid="long", prompt=[60, 2, 2, 1, 9, 9], max_new_tokens=4))
        server.run()
    finally:
        obs.disable()
    summ = rec.summary()
    assert summ["phases"]["prefill"]["count"] > server.admissions
    assert summ["phases"]["decode"]["count"] >= 9


def test_pool_exhaustion_instant_and_pool_stats(params):
    rec = obs.enable(obs.Recorder())
    try:
        engine = _engine("torch", params, **{**PAGED, "slots": 4, "kv_pages": 6})
        server = Server(engine)
        for i in range(5):
            server.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=6))
        assert len(server.run()) == 5
    finally:
        obs.disable()
    summ = rec.summary()
    assert summ["instants"]["kv_pool_exhausted"] >= 1
    stats = server.stats()
    assert stats["concurrency_peak"] == 3
    assert stats["kv_pool_pages"] == 6 and stats["kv_page_size"] == 4
    assert 0 < stats["kv_pool_occupancy_mean"] <= stats["kv_pool_occupancy_peak"] <= 1
    assert engine.allocator.pages_in_use == 0


def test_explicit_kv_dtype_labels_spans(params):
    rec = obs.enable(obs.Recorder())
    try:
        server = Server(_engine("torch", params, **PAGED, kv_dtype="int8"))
        server.submit(Request(rid=0, prompt=[5, 9], max_new_tokens=3))
        server.run()
    finally:
        obs.disable()
    labels = rec.summary()["phases"]["decode"]["labels"]
    assert labels["kv_dtype"] == ["int8"]
    assert server.stats()["kv_dtype"] == "int8"


def test_submit_rejects_never_fitting_request(params):
    server = Server(
        _engine("torch", params, slots=2, max_len=40, prefill_len=20,
                kv_pages=4, kv_page_size=4)
    )
    with pytest.raises(ValueError, match="pool holds only"):
        server.submit(Request(rid=0, prompt=[1] * 12, max_new_tokens=8))


def test_engine_validation(params):
    with pytest.raises(ValueError, match="kv_page_size"):
        _engine("torch", params, slots=1, max_len=40, prefill_len=8,
                kv_pages=8, kv_page_size=7)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine("torch", params, slots=1, max_len=40, prefill_len=8,
                prefill_chunk=4)
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine("torch", params, slots=1, max_len=40, kv_dtype="fp8")
    with pytest.raises(ValueError, match="prefill_paged"):
        _engine("torch", params, **PAGED).prefill(
            np.zeros((2, 8), np.int32), np.ones((2,), np.int32),
            np.ones((2,), bool), np.zeros((2,), np.float32),
            np.zeros((2,), np.int32),
        )
    engine = _engine("torch", params, **PAGED)
    engine.allocator.block_tables[0, 0] = engine.num_pages  # the trash page
    with pytest.raises(RuntimeError, match="outside"):
        engine.decode(np.ones(2, bool), np.zeros(2, np.float32), np.zeros(2, np.int32))


def test_copy_page_and_reset_cover_int8_scales(params):
    engine = _engine("torch", params, **PAGED, kv_dtype="int8")
    k = engine.cache.k
    k.q[:, 3] = 7
    k.scale[:, 3] = 0.5
    engine.copy_page(3, 9)
    assert (k.q[:, 9] == 7).all() and (k.scale[:, 9] == 0.5).all()
    engine.allocator.admit(0, [1, 2, 3], 2)
    engine.reset()
    assert k.q.abs().sum() == 0 and k.scale.abs().sum() == 0
    assert engine.allocator.pages_in_use == 0
