"""mpit_tpu_torch's int8 weight store, through the model, the engine and
the CLI, against the JAX package's.

Both packages quantize the same f32 weights (bit-identical int8 bytes
and scales), with a row-block of 16 on both sides so that the tiny
model's matmuls tile several blocks. Then:

- the param store: the same leaves are quantized, ``params_from_jax``
  carries a JAX-quantized tree bit for bit, and the wire bytes agree;
- GPT-2 tiny in f32 with int8 weights: the logits of the uncached
  forward, of a dense-cache prefill and one decode tick, and of a paged
  prefill chunk within 1e-4 of ``mpit_tpu``'s GPT2 on the same
  quantized params (the two sum the same f32 products in other orders);
- ``Engine`` + ``Server`` with ``weights_dtype="int8"``: dense, paged
  with chunked prefill, and paged with int8 K/V — greedy tokens identical
  to ``mpit_tpu``'s int8-weight engine on the same requests;
- the labels, the validation and the CLI flag behave as in JAX.
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
from mpit_tpu.ops.quantized_matmul import QuantizedTensor as JQuantizedTensor
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve import alloc_cache as j_alloc_cache
from mpit_tpu.serve import kvcache as jkv
from mpit_tpu.serve.weights import params_wire_bytes as j_params_wire_bytes
from mpit_tpu.serve.weights import quantize_gpt2_params as j_quantize
from mpit_tpu_torch import obs
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.serve import (
    Engine,
    Request,
    Server,
    alloc_cache,
    params_from_jax,
    params_wire_bytes,
    quantize_gpt2_params,
)
from mpit_tpu_torch.serve import kvcache as tkv
from mpit_tpu_torch.serve.__main__ import main

TOL = dict(rtol=1e-4, atol=1e-4)
GEO = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2, d_model=32)
JCFG = JConfig.tiny(**GEO, dtype=jnp.float32, quant_block_rows=16)
TCFG = GPT2Config.tiny(**GEO, dtype=torch.float32, quant_block_rows=16)
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5], [9, 9], [3, 1], [60, 2, 2, 1]]
MAX_NEW = [6, 4, 8, 3, 5, 7]
DENSE = dict(slots=2, max_len=40, prefill_len=8)
PAGED = dict(DENSE, kv_pages=24, kv_page_size=4)
STREAMS = {
    "dense": DENSE,
    "paged_chunked": dict(PAGED, prefill_chunk=2),
    "paged_int8_kv": dict(PAGED, kv_dtype="int8"),
}


@pytest.fixture(scope="module")
def params():
    """f32 params made by JAX; the JAX-quantized tree; the port's state."""
    p = jax.jit(JGPT2(JCFG).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    p = jax.tree.map(np.asarray, p)
    return {"jax": p, "jax_q": j_quantize(p), "torch": params_from_jax(p)}


def _stream(engine, server_cls, request_cls):
    server = server_cls(engine)
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return {c.rid: c.tokens for c in server.run()}


@pytest.fixture(scope="module")
def jax_tokens(params):
    """Every stream through JAX's int8-weight engine, once. Its "kernel"
    mode on the CPU runs the blocked matmul (``quantized_matmul_lax``),
    the port's plain version's twin."""
    return {
        name: _stream(
            JEngine(JCFG, params["jax"], weights_dtype="int8", **geo),
            JServer, JRequest,
        )
        for name, geo in STREAMS.items()
    }


# -- the param store ----------------------------------------------------------


def test_quantizes_the_same_leaves_as_jax(params):
    state = quantize_gpt2_params(params["torch"])
    jq = params["jax_q"]
    want = {"wte"} | {
        f"blocks.{i}.{m}.kernel"
        for i in range(GEO["num_layers"])
        for m in ("qkv", "proj", "fc", "out")
    }
    got = {k[: -len(".q")] for k in state if k.endswith(".q")}
    assert got == want
    assert isinstance(jq["wte"], JQuantizedTensor)
    for i in range(GEO["num_layers"]):
        blk = jq[f"block_{i}"]
        for m in ("qkv", "proj", "fc", "out"):
            assert isinstance(blk[m]["kernel"], JQuantizedTensor)
        assert not isinstance(blk["ln1"]["scale"], JQuantizedTensor)
    for key in ("wpe", "ln_f.scale", "blocks.0.qkv.bias"):
        assert state[key].dtype == torch.float32
    # Idempotent, and nothing dequantized.
    again = quantize_gpt2_params(state)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_params_from_jax_carries_quantized_leaves_bit_for_bit(params):
    got = params_from_jax(params["jax_q"])
    want = quantize_gpt2_params(params["torch"])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert got["blocks.0.qkv.kernel.q"].dtype == torch.int8


def test_params_from_jax_rejects_unreadable_leaves(params):
    """A leaf that is neither an array nor a ``.q``/``.scale`` pair
    raises with its path; a bf16 array still converts to f32."""
    wpe = params["jax"]["wpe"]
    got = params_from_jax(dict(params["jax"], wpe=wpe.astype(ml_dtypes.bfloat16)))
    assert got["wpe"].dtype == torch.float32
    assert torch.equal(got["wpe"], torch.from_numpy(
        wpe.astype(ml_dtypes.bfloat16).astype(np.float32)))
    tree = dict(params["jax"], wpe=None)
    with pytest.raises(ValueError, match="'wpe'"):
        params_from_jax(tree)
    tree = dict(params["jax"], ln_f={"scale": "x", "bias": params["jax"]["ln_f"]["bias"]})
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_from_jax(tree)


def test_params_wire_bytes_match_jax(params):
    assert params_wire_bytes(params["torch"]) == j_params_wire_bytes(params["jax"])
    q = quantize_gpt2_params(params["torch"])
    assert params_wire_bytes(q) == j_params_wire_bytes(params["jax_q"])
    assert params_wire_bytes(q) < 0.4 * params_wire_bytes(params["torch"])


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models(params):
    """(JAX model, its quantized params, the port's quantized model)."""
    tmodel = GPT2(TCFG, device="cpu", quantized=True)
    tmodel.load_state_dict(params_from_jax(params["jax_q"]))
    assert tmodel.blocks[0].qkv.kernel.q.dtype == torch.int8
    return JGPT2(JCFG), params["jax_q"], tmodel


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, GEO["vocab_size"], shape).astype(np.int32)


def test_uncached_forward_logits_match_jax(models):
    jmodel, jq, tmodel = models
    toks = _toks((2, 12), 0)
    want = jax.jit(jmodel.apply)({"params": jq}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_prefill_and_decode_tick_logits_match_jax(models):
    jmodel, jq, tmodel = models
    jfwd = jax.jit(lambda p, t, c: jmodel.apply({"params": p}, t, cache=c))
    jc = j_alloc_cache(JCFG, 2, 32)
    tc = alloc_cache(TCFG, 2, 32, device="cpu")
    jk, jv = jc.k, jc.v
    for toks, lengths in (
        (_toks((2, 8), 1), np.zeros(2, np.int32)),
        (_toks((2, 1), 2), np.asarray([5, 8], np.int32)),
    ):
        want, (jk, jv) = jfwd(jq, jnp.asarray(toks), (jk, jv, jnp.asarray(lengths)))
        with torch.no_grad():
            got, _ = tmodel(
                torch.from_numpy(toks).long(),
                cache=(tc.k, tc.v, torch.from_numpy(lengths)),
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_chunk_logits_match_jax(models):
    jmodel, jq, tmodel = models
    ps, n_ps, pages, slots, w = 4, 8, 20, 2, 6
    bt = np.zeros((slots, n_ps), np.int32)
    bt[0, :2], bt[1, :2] = [5, 2], [9, 11]
    toks = _toks((slots, w), 3)
    lengths = np.zeros(slots, np.int32)
    valid = np.ones((slots, w), bool)
    valid[1, 4:] = False  # padding rows of a shorter chunk
    jpool = jkv.alloc_paged_cache(JCFG, slots, pages, ps)
    want, _ = jax.jit(
        lambda p, t, c: jmodel.apply({"params": p}, t, paged_cache=c)
    )(jq, jnp.asarray(toks), (jpool.k, jpool.v, jnp.asarray(lengths),
                              jnp.asarray(bt), jnp.asarray(valid)))
    tpool = tkv.alloc_paged_cache(TCFG, slots, pages, ps, device="cpu")
    with torch.no_grad():
        got, _ = tmodel(
            torch.from_numpy(toks).long(),
            paged_cache=(tpool.k, tpool.v, torch.from_numpy(lengths),
                         torch.from_numpy(bt), torch.from_numpy(valid)),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantized_model_is_loaded_not_initialised():
    with pytest.raises(ValueError, match="loaded"):
        GPT2(TCFG, quantized=True, generator=torch.Generator().manual_seed(0))


# -- the engine and the server ------------------------------------------------


@pytest.mark.parametrize("name", list(STREAMS))
def test_int8_weight_stream_tokens_equal_jax(params, jax_tokens, name):
    engine = Engine(
        TCFG, params["torch"], device="cpu", weights_dtype="int8", **STREAMS[name]
    )
    assert engine.model.wte.q.dtype == torch.int8
    assert _stream(engine, Server, Request) == jax_tokens[name]


def _labelled_run(params, **kw):
    rec = obs.enable(obs.Recorder())
    try:
        server = Server(Engine(TCFG, params["torch"], device="cpu", **DENSE, **kw))
        server.submit(Request(rid=0, prompt=[5, 9], max_new_tokens=3))
        server.run()
    finally:
        obs.disable()
    return rec.summary()["phases"]["decode"].get("labels", {}), server


def test_default_engine_unchanged(params):
    labels, server = _labelled_run(params)
    engine = server.engine
    assert engine.weights_dtype == "f32" and not engine.weights_dtype_explicit
    assert engine.cfg.quant_matmul_fn is None
    assert "weights_dtype" not in labels
    assert server.stats()["weights_dtype"] == "f32"
    assert isinstance(engine.model.blocks[0].qkv.kernel, torch.nn.Parameter)


def test_explicit_int8_labels_spans_and_stats(params):
    labels, server = _labelled_run(params, weights_dtype="int8")
    assert labels["weights_dtype"] == ["int8"]
    assert server.stats()["weights_dtype"] == "int8"
    assert server.engine.weights_dtype_explicit


def test_reference_engine_runs_the_whole_dequant_oracle(params):
    engine = Engine(
        TCFG, params["torch"], device="cpu", decode_attention="reference",
        weights_dtype="int8", **DENSE,
    )
    assert engine.cfg.quant_matmul_fn.func.__name__ == "quantized_matmul_reference"


def test_unknown_weights_dtype_raises(params):
    with pytest.raises(ValueError, match="weights_dtype"):
        Engine(TCFG, params["torch"], device="cpu", weights_dtype="int4", **DENSE)


# -- the CLI ------------------------------------------------------------------


def test_cli_rejects_unknown_dtype_and_int8_with_reference():
    with pytest.raises(SystemExit, match="expected f32 or int8"):
        main(["--device", "cpu", "--weights-dtype", "int4"])
    with pytest.raises(SystemExit, match="reference"):
        main(["--device", "cpu", "--weights-dtype", "int8",
              "--decode-attention", "reference"])


def test_cli_serves_int8_weights_on_the_cpu(capsys):
    out = main(["--device", "cpu", "--model", "tiny", "--weights-dtype", "int8",
                "--requests", "3", "--max-new-tokens", "3", "--slots", "2"])
    assert out["requests_completed"] == 3 and out["generated_tokens"] == 9
    assert out["weights_dtype"] == "int8"
    assert "wd=int8" in capsys.readouterr().err


def test_cli_default_summary_has_no_wd(capsys):
    main(["--device", "cpu", "--model", "tiny", "--requests", "1",
          "--max-new-tokens", "2", "--slots", "1"])
    err = capsys.readouterr().err
    assert "served 1 requests" in err and "wd=" not in err


def test_configs_agree_on_the_quant_fields():
    """The port's config carries the JAX fields with the JAX defaults."""
    j, t = JConfig.tiny(), GPT2Config.tiny()
    assert (t.quant_block_rows, t.quant_matmul_fn) == (j.quant_block_rows, j.quant_matmul_fn)
