"""mpit_tpu_torch's tensor-parallel serving engine (``Engine(world=,
tp_axis=)``, ``serve/tp.py``, ``--mesh``) against mpit_tpu's.

GPT-2 tiny in f32 (4 heads, so p 2 and 4 both divide them), one seeded
JAX init carried over by ``params_from_jax``, a stream of six requests
through two slots (slots are reused), greedy:

- the port's TP engine over ``{"data": 4, "model": 2}`` gives the same
  tokens, token for token, as JAX's TP engine on that mesh of the fake
  CPU mesh (``decode_attention="kernel"``: off the TPU, JAX's reference
  attention and blocked head; the port's plain attention and blocked
  head on the CPU);
- paged with chunked prefill, int8 K/V (dense and paged), int8 weights
  and speculative (k 2, the first layer as the draft, dense and paged),
  each at p 2 and 4, give the tokens of JAX's one-device engine of the
  same form (JAX pins its own TP engines to those: ``tests/test_serve.py``
  ``TestTensorParallelEngine``, ``test_kv_quant.py``
  ``TestQuantizedTensorParallel``, ``test_weights_quant.py``
  ``TestQuantizedWeightsTensorParallel``, ``test_spec.py``
  ``TestSpecTPParity``) and of the port's own one-rank engine;
- each rank holds its heads' cache rows and its weight shards, as JAX's
  ``cache_specs`` / ``paged_cache_specs`` / ``_tp_param_specs`` place
  them (int8 bytes and scales bit for bit); attention runs once a rank a
  layer on H/p heads and the int8 matmul once a rank on each shard;
- the refusals and the CLI's ``--mesh``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import mpit_tpu
from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.parallel.megatron import repack_qkv as j_repack
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve.engine import _tp_param_specs
from mpit_tpu.serve.weights import draft_from_target as j_draft
from mpit_tpu.serve.weights import quantize_gpt2_params as j_quantize
from mpit_tpu_torch import comm
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.serve import (
    Engine,
    Request,
    Server,
    draft_from_target,
    params_from_jax,
    shard_gpt2_params,
)
from mpit_tpu_torch.serve import __main__ as cli
from mpit_tpu_torch.serve import engine as engine_mod

GEO = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=4, d_model=32)
JCFG = JConfig.tiny(**GEO, dtype=jnp.float32, quant_block_rows=16)
TCFG = GPT2Config.tiny(**GEO, dtype=torch.float32, quant_block_rows=16)
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
MAX_NEW = [6, 4, 8, 3, 5, 7]
DENSE = dict(slots=2, max_len=40, prefill_len=8)
PAGED = dict(DENSE, kv_pages=24, kv_page_size=4)
# Each form: (engine keywords, whether it is speculative).
FORMS = {
    "paged_chunked": (dict(PAGED, prefill_chunk=2), False),
    "int8_kv": (dict(DENSE, kv_dtype="int8"), False),
    "paged_int8_kv": (dict(PAGED, kv_dtype="int8"), False),
    "int8_weights": (dict(DENSE, weights_dtype="int8"), False),
    "spec": (DENSE, True),
    "spec_paged": (PAGED, True),
}
CPU = ["--device", "cpu"]
CLI_TIE = 0.01  # logits: the widest gap at which bf16 TP tokens may part


def _stream(engine, server_cls, request_cls):
    server = server_cls(engine)
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return {c.rid: c.tokens for c in server.run()}


@pytest.fixture(scope="module")
def weights():
    """f32 params made by JAX, the port's state, and every JAX stream:
    the TP engine's (dense) and each form's one-device engine's, once."""
    p = jax.jit(JGPT2(JCFG).init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    p = jax.tree.map(np.asarray, p)
    jdraft, jdcfg = j_draft(p, JCFG, 1)
    world = mpit_tpu.init({"data": 4, "model": 2}, set_default=False)
    tokens = {"tp_dense": _stream(
        JEngine(JCFG, p, world=world, tp_axis="model", **DENSE), JServer, JRequest)}
    for name, (geo, spec) in FORMS.items():
        kw = dict(spec_k=2, draft_params=jdraft, draft_cfg=jdcfg) if spec else {}
        tokens[name] = _stream(JEngine(JCFG, p, **geo, **kw), JServer, JRequest)
    return {"jax": p, "torch": params_from_jax(p), "tokens": tokens}


def _engine(state, mesh=None, **kw):
    if mesh is not None:
        kw.update(world=comm.init(mesh, devices=["cpu"]), tp_axis="model")
    return Engine(TCFG, state, device="cpu", **kw)


def _form_kw(state, name):
    geo, spec = FORMS[name]
    if not spec:
        return dict(geo)
    dstate, dcfg = draft_from_target(state, TCFG, 1)
    return dict(geo, spec_k=2, draft_params=dstate, draft_cfg=dcfg)


# -- tokens ---------------------------------------------------------------------


def test_tp_engine_equals_jax_tp_engine(weights):
    mesh = {"data": 4, "model": 2}
    got = _stream(_engine(weights["torch"], mesh, **DENSE), Server, Request)
    assert got == weights["tokens"]["tp_dense"]
    assert got == _stream(_engine(weights["torch"], **DENSE), Server, Request)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", list(FORMS))
def test_tp_forms_equal_one_device_engines(weights, name, p):
    kw = _form_kw(weights["torch"], name)
    got = _stream(_engine(weights["torch"], {"model": p}, **kw), Server, Request)
    assert got == weights["tokens"][name]
    assert got == _stream(_engine(weights["torch"], **kw), Server, Request)


def test_tp_reference_engine_equals_kernel_engine(weights):
    """The reference engine (plain attention, dense sampling) at p 2."""
    ref = _engine(weights["torch"], {"model": 2}, decode_attention="reference", **DENSE)
    assert _stream(ref, Server, Request) == weights["tokens"]["tp_dense"]


# -- layout ---------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cache_is_head_sharded(weights, paged, kv_dtype):
    """Each rank holds ``(L, S, T, H/p, Dh)`` (JAX's
    ``test_tp_cache_is_head_sharded``), or ``(L, pages + 1, ps, H/p,
    Dh)`` on the pool; int8 scales shard on the same head axis; the
    lengths are one for all ranks; a speculative engine's draft cache is
    whole (replicated)."""
    geo = PAGED if paged else DENSE
    dstate, dcfg = draft_from_target(weights["torch"], TCFG, 1)
    e = _engine(weights["torch"], {"data": 4, "model": 2}, kv_dtype=kv_dtype, spec_k=2,
                draft_params=dstate, draft_cfg=dcfg, **geo)
    lead = (geo["kv_pages"] + 1, geo["kv_page_size"]) if paged else (2, 40)
    want = (TCFG.num_layers, *lead, TCFG.num_heads // 2, TCFG.head_dim)
    k = e.cache.k
    payload = k.q if kv_dtype else k
    assert payload.shape == (2, *want) and e.cache.ranks == 2
    assert all(payload[r].shape == want for r in range(2))
    if kv_dtype:
        assert k.scale.shape == (2, *want[:-1], 1)
    assert e.cache.lengths.shape == (2,)
    d = e.draft_cache.k.q if kv_dtype else e.draft_cache.k
    assert d.shape == (1, *lead, TCFG.num_heads, TCFG.head_dim)


@pytest.mark.parametrize("p", [2, 4])
def test_int8_weight_shards_as_jax_places_them(weights, p):
    """Repack, quantize the whole kernel, then cut: every rank's int8
    bytes and scales equal the piece of JAX's TP param tree
    (``_tp_param_specs``) on that device; a column shard carries the
    whole row's scale, a row shard its rows' scales."""
    jparams = {k: j_repack(v, p) if k.startswith("block_") else v
               for k, v in weights["jax"].items()}
    jq = j_quantize(jax.tree.map(jnp.asarray, jparams))
    world = mpit_tpu.init({"model": p}, devices=jax.devices()[:p], set_default=False)
    specs = _tp_param_specs(JCFG, jq, "model")
    state = shard_gpt2_params(weights["torch"], p, quantize=True)
    order = {dev: i for i, dev in enumerate(world.mesh.devices.flat)}
    d, ff = TCFG.d_model, TCFG.ff_dim
    for mod, q_shape, s_shape in (("qkv", (p, d, 3 * d // p), (d, 1)),
                                  ("fc", (p, d, ff // p), (d, 1)),
                                  ("proj", (p, d // p, d), (p, d // p, 1)),
                                  ("out", (p, ff // p, d), (p, ff // p, 1))):
        tq, ts = state[f"blocks.0.{mod}.kernel.q"], state[f"blocks.0.{mod}.kernel.scale"]
        assert tq.shape == q_shape and ts.shape == s_shape, mod
        jk, sk = jq["block_0"][mod]["kernel"], specs["block_0"][mod]["kernel"]
        for leaf, spec, tensor in (("q", sk.q, tq), ("scale", sk.scale, ts)):
            placed = jax.device_put(getattr(jk, leaf), NamedSharding(world.mesh, spec))
            for s in placed.addressable_shards:
                r = order[s.device]
                mine = tensor if tensor.dim() == 2 else tensor[r]
                assert np.array_equal(mine.numpy(), np.asarray(s.data)), (mod, leaf, r)
    # The replicated leaves stay whole.
    assert state["wte.q"].shape == (TCFG.vocab_size, d)
    assert state["blocks.0.proj.bias"].shape == (d,)


@pytest.mark.parametrize("int8w", [False, True], ids=["f32", "int8w"])
def test_attention_and_matmul_run_once_a_rank_on_their_shards(weights, monkeypatch, int8w):
    """Each layer of a forward calls the engine's attention once a rank
    on that rank's H/p heads, and (int8 weights) the matmul once a rank
    a dense layer on that rank's shard: the calls the kernels take on
    the card."""
    heads, shapes = [], []

    def attention(q, k, v, lengths, *a, **kw):
        heads.append((q.shape[2], k.shape[-2]))
        return real_attention(q, k, v, lengths, *a, **kw)

    def matmul(x, w, **kw):
        shapes.append(tuple(w.q.shape))
        return real_matmul(x, w, **kw)

    real_attention, real_matmul = engine_mod.flash_decode_attention, engine_mod.quantized_matmul
    monkeypatch.setattr(engine_mod, "flash_decode_attention", attention)
    monkeypatch.setattr(engine_mod, "quantized_matmul", matmul)
    p = 4
    e = _engine(weights["torch"], {"model": p}, weights_dtype="int8" if int8w else None,
                **DENSE)
    every = np.ones(2, bool)
    zeros = np.zeros(2, np.float32), np.zeros(2, np.int32)
    e.prefill(np.ones((2, 8), np.int64), np.array([3, 5]), every, *zeros)
    e.decode(every, *zeros)
    hl = TCFG.num_heads // p
    assert heads == [(hl, hl)] * (2 * TCFG.num_layers * p)
    d, ff = TCFG.d_model, TCFG.ff_dim
    one_layer = [(d, 3 * d // p)] * p + [(d // p, d)] * p + [(d, ff // p)] * p \
        + [(ff // p, d)] * p
    assert shapes == (one_layer * TCFG.num_layers * 2 if int8w else [])


# -- refusals -------------------------------------------------------------------


def test_refusals(weights):
    state = weights["torch"]
    with pytest.raises(ValueError, match=r"num_heads \(4\) must divide TP=3"):
        _engine(state, {"model": 3}, **DENSE)
    with pytest.raises(ValueError, match="tp_axis requires a World"):
        Engine(TCFG, state, device="cpu", tp_axis="model", **DENSE)
    with pytest.raises(ValueError, match="without tp_axis"):
        Engine(TCFG, state, device="cpu", world=comm.init({"model": 2}, devices=["cpu"]),
               **DENSE)
    e = _engine(state, {"model": 2}, **DENSE)
    with pytest.raises(ValueError, match="8c"):
        e.export_kv_rows(0, 1)
    with pytest.raises(ValueError, match="8c"):
        e.inject_kv_rows(0, None, None, 1, 0)
    with pytest.raises(SystemExit, match="8c"):
        cli.main([*CPU, "--mesh", "model=2", "--fleet", "prefill=1,decode=1"])
    with pytest.raises(SystemExit, match="§A 10"):
        comm.init({"data": 2, "expert": 2}, devices=["cpu"])


# -- the CLI --------------------------------------------------------------------


# A short stream: the CLI's tiny model, six requests of eight tokens.
CLI = [*CPU, "--model", "tiny", "--requests", "6", "--max-new-tokens", "8"]


def _cli_tokens(args):
    cfg = cli.from_argv(cli.ServeConfig, [*CLI, *args])
    engine, mcfg = cli._build_engine(cfg)
    server = Server(engine)
    reqs = list(cli.synthetic_requests(cfg, mcfg.vocab_size))
    for req in reqs:
        server.submit(req)
    return {c.rid: c.tokens for c in server.run()}, engine, {r.rid: r.prompt for r in reqs}


@pytest.mark.parametrize("extra,meshes", [
    ([], (("model=2", 2), ("data=2", 2), ("data=2,model=4", 4))),
    (["--kv-pages", "32", "--kv-page-size", "8", "--prefill-chunk", "4"], (("model=2", 2),)),
], ids=["dense", "paged"])
def test_cli_mesh_serves_the_tokens_of_one_rank(extra, meshes):
    """The CLI's tiny model is bf16: each rank's row-parallel partial is
    rounded to bf16 before the rank-order sum (as JAX's psum of bf16
    partials), where one rank rounds the whole product once. So a
    request's tokens equal the one-rank run's, or part first where the
    one-rank model, teacher-forced on its own tokens, ranks the two
    within ``CLI_TIE`` logits (seen: 2.2e-4 on one request of 16 at p 2,
    none at p 4). ``--mesh data=2`` is TP over the data axis, as in the
    JAX CLI."""
    want, one, prompts = _cli_tokens(extra)
    for mesh, p in meshes:
        got, engine, _ = _cli_tokens([*extra, "--mesh", mesh])
        assert engine.tp == p and got.keys() == want.keys(), mesh
        for rid, toks in want.items():
            if got[rid] == toks:
                continue
            i = next(j for j, (a, b) in enumerate(zip(got[rid], toks)) if a != b)
            with torch.no_grad():
                row = one.model(torch.tensor([prompts[rid] + toks[:i]]))[0, -1].float()
            assert abs(row[toks[i]] - row[got[rid][i]]).item() <= CLI_TIE, (mesh, rid, i)
    out = cli.main([*CLI, "--mesh", "model=2", *extra])
    assert out["tensor_parallel"] == 2 and out["requests_completed"] == 6

