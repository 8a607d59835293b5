"""mpit_tpu_torch's speculative decoding (``serve/spec.py``,
``ops/lm_head.py::lm_head_verify``, ``serve/weights.py::draft_from_target``,
the engine's ``spec_draft`` / ``spec_verify``, the scheduler's
speculative tick and the CLI's draft flags) against mpit_tpu's, on the
CPU.

The configs are ``tests/test_spec.py``'s (``CFG``, ``DCFG``,
``PROMPTS``, ``MAX_NEW``), the weights JAX's init carried over by
``params_from_jax``. JAX's side runs once, in a module fixture: its
plain engine and its speculative engine (k 2) over the stream.
Tolerances, with their reasons:

- greedy tokens: equal, request for request, to JAX's speculative and
  plain engines and to the port's plain engine, dense and paged (prefix
  sharing, chunked prefill), at k 2 and 3, on the kernel engine (the
  plain versions here) and the reference engine;
- ``accept_emit``: equal to JAX's on the same inputs (integer and
  comparison logic);
- ``draft_distribution`` and ``verify_reference`` against JAX's on the
  same logits and JAX's own Gumbel draws (``gumbel(fold_in(key, b),
  ...)``, handed over as tensors): the scaled logits equal, ``q`` and
  ``p_x`` within 1e-6 (``exp``/``log`` of the two libraries may part
  in the last ulp), greedy and residual tokens equal;
- ``lm_head_verify`` against ``verify_reference`` bitwise at one vocab
  block (the shared noise contract), and against JAX's
  ``lm_head_verify`` as ``verify_reference`` is held to JAX's;
- the emitted marginal of drafted-then-accepted-or-residual tokens
  against the target's modified distribution: total variation below
  0.02 over 20,000 draws (the sampling error of 16 bins at that count
  is about 0.01).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import GPT2 as JGPT2
from mpit_tpu.models import GPT2Config as JGPT2Config
from mpit_tpu.ops.lm_head import lm_head_verify as j_lm_head_verify
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve import spec as jspec
from mpit_tpu_torch import obs
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.ops.lm_head import lm_head_verify
from mpit_tpu_torch.serve import (
    Engine, Request, Server, draft_from_target, params_from_jax, spec,
)
from mpit_tpu_torch.serve import __main__ as cli

JCFG = JGPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
                        d_model=32, dtype=jnp.float32)
JDCFG = JGPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=1, num_heads=2,
                         d_model=32, dtype=jnp.float32)
CFG = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32,
                      dtype=torch.float32)
DCFG = GPT2Config.tiny(vocab_size=64, max_seq_len=64, num_layers=1, num_heads=2, d_model=32,
                       dtype=torch.float32)

PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
MAX_NEW = [6, 4, 8, 3, 5, 7]
GEOM = dict(slots=2, max_len=40, prefill_len=8)
CPU = ["--device", "cpu"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """JAX's target and draft params, and the JAX engines' tokens."""
    params = _np(jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
                 ["params"])
    dparams = _np(jax.jit(JGPT2(JDCFG).init)(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
                  ["params"])

    def jrun(**kw):
        server = JServer(JEngine(JCFG, jax.tree.map(jnp.asarray, params), **GEOM, **kw))
        for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
            server.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
        server.run()
        return {c.rid: c.tokens for c in server.completed}

    jax_plain = jrun()
    jax_spec = jrun(spec_k=2, draft_params=jax.tree.map(jnp.asarray, dparams), draft_cfg=JDCFG)
    return params_from_jax(params), params_from_jax(dparams), jax_plain, jax_spec


def _spec_kw(dstate, k=2, dcfg=DCFG):
    return dict(spec_k=k, draft_params=dstate, draft_cfg=dcfg)


def _reqs(prompts=PROMPTS, max_new=MAX_NEW):
    return [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]


def _run(engine, reqs=None):
    server = Server(engine)
    for r in reqs or _reqs():
        server.submit(r)
    server.run()
    return {c.rid: c.tokens for c in server.completed}, server


def _engine(state, **kw):
    return Engine(CFG, state, device="cpu", **{**GEOM, **kw})


@pytest.fixture(scope="module")
def port_plain(weights):
    state, _, jax_plain, jax_spec = weights
    out, _ = _run(_engine(state))
    assert out == jax_plain == jax_spec  # JAX's own pin, and the port's plain engine
    return out


_GREEDY_CASES = {
    "dense_k2": dict(),
    "dense_k3": dict(k=3),
    "dense_reference_k2": dict(decode_attention="reference"),
    "paged_prefix_k2": dict(kv_pages=16, kv_page_size=8),
    "paged_chunked_k3": dict(k=3, kv_pages=16, kv_page_size=8, prefill_chunk=4),
}


@pytest.mark.parametrize("case", sorted(_GREEDY_CASES))
def test_greedy_tokens_equal_jax_spec_and_plain(weights, port_plain, case):
    state, dstate, _, jax_spec = weights
    kw = dict(_GREEDY_CASES[case])
    k = kw.pop("k", 2)
    out, server = _run(_engine(state, **kw, **_spec_kw(dstate, k)))
    assert out == jax_spec == port_plain
    st = server.stats()
    assert st["spec_k"] == k and st["accepted_tokens_per_tick"] >= 1.0
    assert st["spec_drafted_tokens"] > st["spec_accepted_tokens"]  # a random draft


def test_perfect_draft_accepts_every_token(weights):
    """The draft IS the target: every drafted token is accepted on every
    tick, dense and paged. Greedy parity cannot see a corrupted draft
    context (the verify corrects it); sustained acceptance can, e.g. a
    missing head-less append after a fully accepted tick."""
    state, *_ = weights
    reqs = [Request(rid=i, prompt=p, max_new_tokens=10) for i, p in enumerate(PROMPTS[:4])]
    for kw in ({}, {"kv_pages": 16, "kv_page_size": 8}):
        _, server = _run(_engine(state, **kw, **_spec_kw(state, 3, CFG)), reqs)
        assert server.stats()["draft_acceptance_rate"] == 1.0, kw


def _paged_k3(state, dstate, **kw):
    return _engine(state, prefill_len=24, kv_pages=24, kv_page_size=4,
                   **_spec_kw(dstate, 3), **kw)


def test_rollback_across_a_page_boundary(weights):
    """Pages of 4 rows under a verify of k + 1 = 4: every tick's span
    crosses a page boundary, so a rejection pulls the fill back over
    one. Tokens equal the plain paged run's."""
    state, dstate, *_ = weights
    ref, _ = _run(_engine(state, prefill_len=24, kv_pages=24, kv_page_size=4))
    out, server = _run(_paged_k3(state, dstate))
    assert out == ref
    assert server._spec_accepted < server._spec_drafted


def test_rollback_into_a_cow_shared_page(weights):
    """Full-prompt prefix reuse: the sharer's first speculative writes
    land in the copied partial page, rejections roll back inside it."""
    state, dstate, *_ = weights
    prefix = np.random.RandomState(3).randint(0, CFG.vocab_size, size=6).tolist()

    def two(engine):
        server = Server(engine)
        server.submit(Request(rid="a", prompt=prefix, max_new_tokens=8))
        server.run(max_ticks=2)  # "a"'s prefix registered first
        server.submit(Request(rid="b", prompt=prefix, max_new_tokens=8))
        server.run()
        return {c.rid: c.tokens for c in server.completed}

    ref = two(_engine(state, prefill_len=24, kv_pages=24, kv_page_size=4))
    eng = _paged_k3(state, dstate)
    assert two(eng) == ref
    assert eng.allocator.cow_copies >= 1


def test_mapped_tokens_is_each_slots_write_cap(weights):
    state, dstate, *_ = weights
    eng = _paged_k3(state, dstate)
    server = Server(eng)
    server.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=6))
    server.run(max_ticks=1)
    caps = eng.allocator.mapped_tokens()
    assert caps.dtype == np.int32 and caps.tolist() == [12, 0]  # ceil(11 / 4) pages of 4


def test_accept_emit_equals_jax():
    rng = np.random.default_rng(0)
    s, k = 6, 3
    drafted = rng.integers(0, 8, (s, k)).astype(np.int32)
    greedy = rng.integers(0, 8, (s, k + 1)).astype(np.int32)
    greedy[:2, :k] = drafted[:2]  # some greedy rows accept everything
    p_x, q_x, u = (rng.random((s, k)).astype(np.float32) for _ in range(3))
    repl = rng.integers(0, 8, (s, k + 1)).astype(np.int32)
    greedy_row = np.array([True, True, True, False, False, False])
    budget = np.array([8, 2, 8, 8, 1, 8], np.int32)
    eos = np.array([-1, -1, int(drafted[2, 0]), -1, -1, int(drafted[5, 1])], np.int32)
    args = (drafted, greedy, p_x, q_x, u, repl, greedy_row, budget, eos)
    want = jspec.accept_emit(*map(jnp.asarray, args))
    got = spec.accept_emit(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_accept_emit_clamps_at_eos_and_budget():
    drafted = torch.tensor([[4, 7, 5], [4, 7, 5]], dtype=torch.int32)
    greedy = torch.cat([drafted, drafted[:, :1]], dim=1)
    z = torch.zeros((2, 3))
    emit, n_emit, n_acc = spec.accept_emit(
        drafted, greedy, z, z, z, greedy, torch.tensor([True, True]),
        torch.tensor([8, 2], dtype=torch.int32), torch.tensor([7, -1], dtype=torch.int32),
    )
    assert n_acc.tolist() == [3, 3] and n_emit.tolist() == [2, 2]
    assert emit[0, :2].tolist() == [4, 7]


def _sampling_rows(n=6, v=64, seed=42):
    kr = jax.random.key(seed)
    h = np.asarray(jax.random.normal(jax.random.fold_in(kr, 0), (n, 16), jnp.float32))
    head = np.asarray(jax.random.normal(jax.random.fold_in(kr, 1), (v, 16), jnp.float32))
    q = np.array(jax.nn.softmax(jax.random.normal(jax.random.fold_in(kr, 2), (n, v)), -1))
    q[-1] = 0.0  # a bonus row: the residual is a plain target sample
    drafted = np.asarray(jax.random.randint(jax.random.fold_in(kr, 3), (n,), 0, v, jnp.int32))
    temp = np.array([0.0, 0.0, 0.7, 0.7, 1.3, 0.9], np.float32)
    topk = np.array([0, 4, 0, 8, 3, 0], np.int32)
    return h, head, q, drafted, temp, topk, jax.random.fold_in(kr, 4)


def _jax_noise(vkey, n, v, k_cap):
    """JAX's draws in the verifiers: one block (v pads to 128), the
    block's ``gumbel(fold_in(key, 0), (n, 128))`` and the buffer's
    ``gumbel(fold_in(key, 1), (n, kb))``."""
    noise = jax.random.gumbel(jax.random.fold_in(vkey, 0), (n, 128), jnp.float32)
    buf = jax.random.gumbel(jax.random.fold_in(vkey, 1), (n, min(k_cap, v)), jnp.float32)
    return torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(buf))


def test_verify_reference_and_lm_head_verify_equal_jax():
    h, head, q, drafted, temp, topk, vkey = _sampling_rows()
    logits = np.asarray(jnp.dot(h, head.T, preferred_element_type=jnp.float32))
    jref = jspec.verify_reference(jnp.asarray(logits), drafted, q, vkey, temp, topk, k_cap=16)
    jblk = j_lm_head_verify(jnp.asarray(h), jnp.asarray(head), drafted, q, vkey, temp, topk,
                            k_cap=16)
    noise, buf = _jax_noise(vkey, 6, 64, 16)
    t = torch.from_numpy
    tref = spec.verify_reference(t(logits), t(drafted), t(q), t(temp), t(topk), k_cap=16,
                                 noise=noise, buffer_noise=buf)
    tblk = lm_head_verify(t(h), t(head), t(drafted), t(q), t(temp), t(topk), k_cap=16,
                          noise=noise, buffer_noise=buf)
    for got, want in ((tref, jref), (tblk, jblk)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_lm_head_verify_bitwise_against_verify_reference_at_one_block():
    h, head, q, drafted, temp, topk, _ = _sampling_rows(seed=7)
    t = torch.from_numpy
    logits = t(h).float() @ t(head).float().T  # the blocked path's one block
    for seed in range(3):  # the generator's draws: the buffer's, then the block's
        a = spec.verify_reference(logits, t(drafted), t(q), t(temp), t(topk), k_cap=16,
                                  generator=torch.Generator().manual_seed(seed))
        b = lm_head_verify(t(h), t(head), t(drafted), t(q), t(temp), t(topk), k_cap=16,
                           generator=torch.Generator().manual_seed(seed))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # Two blocks of 32 against one: the same greedy and p_x within an ulp.
    c = lm_head_verify(t(h), t(head), t(drafted), t(q), t(temp), t(topk), k_cap=16,
                       block_size=32, generator=torch.Generator())
    assert torch.equal(c[0], a[0])
    np.testing.assert_allclose(c[1].numpy(), a[1].numpy(), rtol=1e-6, atol=1e-7)


def test_draft_distribution_equals_jax_and_the_engine_sampler():
    kr = jax.random.key(5)
    logits = np.asarray(jax.random.normal(kr, (6, 64), jnp.float32) * 3.0)
    temp = np.array([0.3, 0.7, 1.0, 1.3, 2.0, 0.9], np.float32)
    topk = np.array([0, 4, 1, 8, 3, 63], np.int32)
    jprobs, jscaled = jspec.draft_distribution(jnp.asarray(logits), temp, topk)
    t = torch.from_numpy
    probs, scaled = spec.draft_distribution(t(logits), t(temp), t(topk))
    np.testing.assert_array_equal(scaled.numpy(), np.asarray(jscaled))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    # The engine's sampler reads the same modification (one function).
    from mpit_tpu_torch.serve import engine

    assert engine.modified_logits is spec.modified_logits
    noise = torch.from_numpy(np.random.default_rng(0).gumbel(size=(6, 64)).astype(np.float32))
    drawn = (scaled + noise).argmax(-1).int()
    assert torch.equal(drawn, engine.sample_tokens(t(logits), t(temp), t(topk), noise=noise))


def test_emitted_marginal_is_the_target_distribution():
    """Rejection sampling's exactness, measured: x ~ q, accepted when
    u·q(x) < p(x), else the residual; the emitted tokens follow p, the
    target's modified distribution, for a q that disagrees with it."""
    v, trials = 16, 20000
    g = torch.Generator().manual_seed(9)
    logits = torch.randn((1, v), generator=g) * 2.0
    qlogits = torch.randn((1, v), generator=g) * 2.0
    temp = torch.full((trials,), 0.8)
    topk = torch.zeros((trials,), dtype=torch.int32)
    q = torch.softmax(qlogits / 0.8, dim=-1)
    p = torch.softmax(logits / 0.8, dim=-1)[0]
    x = torch.multinomial(q.expand(trials, v), 1, replacement=True, generator=g)[:, 0]
    _, p_x, repl = spec.verify_reference(logits.expand(trials, v), x, q.expand(trials, v), temp,
                                         topk, k_cap=v, generator=g)
    u = torch.rand((trials,), generator=g)
    q_x = q[0, x]
    toks = torch.where(u * q_x < p_x, x, repl.long())
    emp = torch.bincount(toks, minlength=v).double() / trials
    assert 0.5 * (emp - p.double()).abs().sum().item() < 0.02


def test_sampled_spec_bookkeeping(weights):
    """Temperature and top-k speculation end to end: counts, lengths and
    retirement stay coherent (sampling makes no parity claim)."""
    state, dstate, *_ = weights
    for kw in ({}, {"kv_pages": 16, "kv_page_size": 8}):
        eng = _engine(state, **kw, **_spec_kw(dstate))
        server = Server(eng)
        server.submit(Request(rid=0, prompt=[5, 9, 3], max_new_tokens=6, temperature=0.8))
        server.submit(Request(rid=1, prompt=[7, 2], max_new_tokens=5, temperature=0.9,
                              top_k=4))
        by = {c.rid: c.tokens for c in server.run()}
        assert len(by[0]) == 6 and len(by[1]) == 5
        assert 0 <= int(eng.lengths().min()) and int(eng.lengths().max()) <= 40
        st = server.stats()
        assert 0.0 <= st["draft_acceptance_rate"] <= 1.0


def test_spans_and_counters(weights):
    state, dstate, *_ = weights
    rec = obs.enable(obs.Recorder())
    try:
        _, server = _run(_engine(state, **_spec_kw(dstate)))
    finally:
        obs.disable()
    summ = rec.summary()
    phases = summ["phases"]
    for name in ("decode", "spec_draft", "spec_verify"):
        assert phases[name]["labels"]["attention"] == ["kernel"], name
    counters = summ["counters"]
    st = server.stats()
    assert counters["spec_drafted_tokens"] == st["spec_drafted_tokens"]
    assert counters["spec_accepted_tokens"] == st["spec_accepted_tokens"]


def test_construction_and_submit_errors(weights):
    state, dstate, *_ = weights
    with pytest.raises(ValueError, match="requires draft_params"):
        _engine(state, spec_k=2)
    with pytest.raises(ValueError, match="without spec_k"):
        _engine(state, draft_params=dstate, draft_cfg=DCFG)
    bad_vocab = GPT2Config.tiny(vocab_size=32, max_seq_len=64, num_layers=1, num_heads=2,
                                d_model=32, dtype=torch.float32)
    with pytest.raises(ValueError, match="vocab_size"):
        _engine(state, **_spec_kw(dstate, dcfg=bad_vocab))
    short = GPT2Config.tiny(vocab_size=64, max_seq_len=16, num_layers=1, num_heads=2,
                            d_model=32, dtype=torch.float32)
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(state, **_spec_kw(dstate, dcfg=short))
    with pytest.raises(ValueError, match="spec_k must be"):
        _engine(state, **_spec_kw(dstate, k=-1))
    eng = _engine(state, **_spec_kw(dstate, k=3))
    with pytest.raises(ValueError, match="spec_draft \\+ spec_verify"):
        eng.decode(np.zeros(2, bool), np.zeros(2, np.float32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="without a pending spec_draft"):
        eng.spec_verify(*(np.zeros(2),) * 5)
    server = Server(eng)
    with pytest.raises(ValueError, match="speculative decode"):
        server.submit(Request(rid="x", prompt=[1] * 8, max_new_tokens=31))  # 8 + 31 + 2 > 40
    server.submit(Request(rid="ok", prompt=[1] * 8, max_new_tokens=30))
    paged = Server(_engine(state, kv_pages=16, kv_page_size=8, **_spec_kw(dstate, k=3)))
    paged.submit(Request(rid="x", prompt=[1] * 8, max_new_tokens=32))  # pools need none


def test_draft_from_target(weights):
    state, *_ = weights
    dst, dcfg = draft_from_target(state, CFG, 1)
    assert dcfg.num_layers == 1 and dcfg.vocab_size == CFG.vocab_size
    assert not any(n.startswith("blocks.1.") for n in dst)
    assert all(dst[n] is state[n] for n in dst)  # aliases, not copies
    assert {n for n in state if not n.startswith("blocks.1.")} == set(dst)
    for n in (0, 2):
        with pytest.raises(ValueError, match="num_layers"):
            draft_from_target(state, CFG, n)


def _cli_tokens(argv):
    cfg = cli.from_argv(cli.ServeConfig, [*argv, *CPU])
    cli._check_flags(cfg)
    engine, mcfg = cli._build_engine(cfg)
    server = Server(engine)
    for req in cli.synthetic_requests(cfg, mcfg.vocab_size):
        server.submit(req)
    return {c.rid: c.tokens for c in server.run()}, server.stats()


@pytest.mark.parametrize("extra", [
    [], ["--kv-pages", "32", "--kv-page-size", "8", "--prefill-chunk", "4"],
    ["--kv-pages", "32", "--kv-page-size", "8", "--prefill-chunk", "4", "--weights-dtype",
     "int8"],
], ids=["dense", "paged_chunked", "paged_chunked_int8w"])
def test_cli_spec_tokens_equal_plain(extra):
    argv = ["--model", "tiny", "--requests", "6", *extra]
    plain, _ = _cli_tokens(argv)
    got, st = _cli_tokens([*argv, "--spec-k", "2", "--draft-config", "truncate:1"])
    assert got == plain and len(got) == 6 and st["spec_k"] == 2


def test_cli_main_and_draft_config_tiny():
    out = cli.main(["--model", "tiny", "--requests", "3", "--spec-k", "2", "--draft-config",
                    "tiny", *CPU])
    assert out["requests_completed"] == 3 and out["spec_k"] == 2
    assert "accepted_tokens_per_tick" in out


@pytest.mark.parametrize("argv,match", [
    (["--spec-k", "2"], "needs a draft"),
    (["--spec-k", "2", "--draft-config", "truncate:x"], "truncate:<num_layers>"),
    (["--spec-k", "2", "--draft-config", "truncate:2"], "need 1 <= N"),
    (["--spec-k", "2", "--draft-config", "tiny", "--draft-ckpt", "/d.npz"], "mutually"),
    (["--draft-config", "tiny"], "require --spec-k"),
    (["--spec-k", "4", "--draft-config", "tiny", "--max-len", "24"], "on the dense engine"),
    (["--spec-k", "2", "--draft-config", "tiny", "--fleet", "prefill=1,decode=1"],
     "target's cache only"),
])
def test_cli_draft_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--model", "tiny", *argv, *CPU])
