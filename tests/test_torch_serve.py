"""mpit_tpu_torch serving against the JAX package's, on the CPU.

- the blocked LM head: greedy equals JAX's exactly; with the same Gumbel
  numbers fed to both (torch cannot draw JAX's ``fold_in`` noise), the
  temperature and top-k draws are equal too, as are the dense sampler's;
- a staggered stream of greedy requests through the port's ``Engine`` +
  ``Server`` gives the very tokens ``mpit_tpu``'s ``Server`` gives on
  the same weights, in both attention modes;
- the CLI: ``main`` returns the stats keys, serves through the paged
  pool (f32/bf16 and int8), rejects the combinations the JAX CLI rejects
  and the single Server's flags beside ``--fleet``, and defaults to the
  GPU (it raises here, where there is none).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.ops.lm_head import lm_head_sample as j_lm_head_sample
from mpit_tpu.serve import Engine as JEngine
from mpit_tpu.serve import Request as JRequest
from mpit_tpu.serve import Server as JServer
from mpit_tpu.serve.engine import sample_tokens as j_sample_tokens
from mpit_tpu_torch.models import GPT2Config
from mpit_tpu_torch.ops import lm_head_sample
from mpit_tpu_torch.serve import (
    Engine,
    Request,
    Server,
    params_from_jax,
    sample_tokens,
    warm_engine,
)
from mpit_tpu_torch.serve.__main__ import main

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
GEOMETRY = dict(slots=2, max_len=40, prefill_len=8)


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JGPT2(JCFG).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def jax_tokens(params):
    """The JAX server's greedy tokens for the staggered stream."""
    server = JServer(JEngine(JCFG, params, **GEOMETRY))
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
    return {c.rid: c.tokens for c in server.run()}


def _head_inputs(n=5, vocab=300, d=32, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    head = rng.standard_normal((vocab, d)).astype(np.float32)
    return h, head


def test_lm_head_greedy_equals_jax():
    h, head = _head_inputs()
    temp = np.zeros(5, np.float32)
    topk = np.zeros(5, np.int32)
    want = j_lm_head_sample(
        jnp.asarray(h), jnp.asarray(head), jax.random.key(0),
        jnp.asarray(temp), jnp.asarray(topk), block_size=128,
    )
    got = lm_head_sample(
        torch.from_numpy(h), torch.from_numpy(head), torch.from_numpy(temp),
        torch.from_numpy(topk), block_size=128,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_head_sampled_draws_equal_jax_with_shared_noise():
    """Rows mix greedy, full-vocabulary temperature and top-k draws; the
    last vocabulary block (300 = 2 x 128 + 44) is partial."""
    h, head = _head_inputs()
    block, key = 128, jax.random.key(7)
    temp = np.asarray([0.0, 0.7, 1.3, 0.9, 2.0], np.float32)
    topk = np.asarray([0, 0, 5, 1, 40], np.int32)
    # JAX's own noise: block i draws gumbel(fold_in(key, i), (n, block)).
    noise = np.concatenate(
        [
            np.array(jax.random.gumbel(jax.random.fold_in(key, i), (5, block)))
            for i in range(3)
        ],
        axis=1,
    )
    want = j_lm_head_sample(
        jnp.asarray(h), jnp.asarray(head), key, jnp.asarray(temp),
        jnp.asarray(topk), block_size=block,
    )
    got = lm_head_sample(
        torch.from_numpy(h), torch.from_numpy(head), torch.from_numpy(temp),
        torch.from_numpy(topk), noise=torch.from_numpy(noise),
        block_size=block,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_sampler_equals_jax_with_shared_noise():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((4, 50))).astype(np.float32)
    temp = np.asarray([0.0, 0.5, 1.0, 1.5], np.float32)
    topk = np.asarray([0, 0, 3, 10], np.int32)
    key = jax.random.key(11)
    # jax.random.categorical draws argmax(logits + gumbel(key, shape)).
    noise = np.array(jax.random.gumbel(key, logits.shape))
    want = j_sample_tokens(
        jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(topk)
    )
    got = sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(topk), noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_staggered_stream_tokens_equal_jax_server(params, jax_tokens, mode):
    """Six requests through two slots: admits ride later prefills as
    slots retire, and every request's greedy tokens equal the JAX
    server's."""
    engine = Engine(
        TCFG, params_from_jax(params), device="cpu", decode_attention=mode,
        **GEOMETRY,
    )
    server = Server(engine)
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    done = {c.rid: c.tokens for c in server.run()}
    assert server.admissions == len(PROMPTS) > engine.slots
    assert done == jax_tokens


def test_retirement_rules(params):
    """EOS and max-new-tokens retire a slot; a request that fills its
    slot's whole cache completes untruncated."""
    engine = Engine(
        TCFG, params_from_jax(params), device="cpu", slots=2, max_len=16,
        prefill_len=8,
    )
    server = Server(engine)
    server.submit(Request(rid="n", prompt=[1, 2], max_new_tokens=3))
    done = {c.rid: c for c in server.run()}
    assert len(done["n"].tokens) == 3 and not done["n"].truncated
    eos = done["n"].tokens[1]
    server.submit(Request(rid="e", prompt=[1, 2], max_new_tokens=9, eos_id=eos))
    server.submit(Request(rid="f", prompt=[3] * 8, max_new_tokens=8))
    done = {c.rid: c for c in server.run()}
    want = done["n"].tokens
    assert done["e"].tokens == want[: want.index(eos) + 1]
    assert len(done["f"].tokens) == 8 and not done["f"].truncated
    stats = server.stats()
    assert stats["requests_completed"] == 3 and not stats["truncated"]


def test_warm_engine_leaves_a_clean_engine(params, jax_tokens):
    """After the throwaway warm request the engine is reset: a stream
    served next gives the tokens of a fresh engine."""
    engine = Engine(TCFG, params_from_jax(params), device="cpu", **GEOMETRY)
    warm_engine(engine)
    assert not engine.lengths().any()
    server = Server(engine)
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    assert {c.rid: c.tokens for c in server.run()} == jax_tokens


def test_main_returns_stats_keys():
    out = main([
        "--device", "cpu", "--model", "tiny", "--requests", "5",
        "--max-new-tokens", "3", "--slots", "2",
    ])
    for key in (
        "model", "device", "wall_s", "decode_tokens_per_sec",
        "decode_attention", "decode_sampler", "requests_completed",
        "ticks", "admissions", "generated_tokens", "occupancy_mean",
        "truncated", "concurrency_peak", "kv_dtype", "weights_dtype",
        "latency_p50_s", "latency_p95_s", "ttft_p50_s", "ttft_p95_s",
        "obs_summary",
    ):
        assert key in out, key
    assert out["requests_completed"] == 5 and out["generated_tokens"] == 15
    assert out["device"] == "cpu" and out["decode_attention"] == "kernel"
    assert {"prefill", "decode", "request_ttft"} <= set(out["obs_summary"])


@pytest.mark.parametrize(
    "flags",
    [
        # The host KV tier is served now; it spills pool pages, so it
        # refuses without the pool.
        ["--kv-host-pages", "8"],
        # Not later slices: the JAX CLI rejects them too (the reference
        # path is the parity oracle, not an int8 serving path).
        ["--kv-dtype", "int8", "--decode-attention", "reference"],
        ["--weights-dtype", "int8", "--decode-attention", "reference"],
        # Speculation and the trace are served now; a dense geometry
        # without the verify's headroom refuses, before a model is built.
        ["--spec-k", "2", "--draft-config", "truncate:1", "--trace", "t.json",
         "--max-len", "24"],
        # --mesh serves now (tensor parallelism); beside --fleet it refuses,
        # naming the item that brings the fleet over it.
        ["--mesh", "model=2", "--fleet", "prefill=1,decode=1"],
        # The load harness and the SLO monitor are served now; beside the
        # fleet's router (its own admission) they refuse.
        ["--loadgen", "rate=8", "--slo-shed-rate", "0.1", "--fleet", "prefill=1,decode=1"],
        # The policy is served now; a bad spec refuses before a model is built.
        ["--policy", "quantum=0"],
        # The fleet's router runs its own closed-loop admission: the
        # Server's policy refuses beside it, before any worker starts.
        ["--fleet", "prefill=1,decode=1", "--policy", "on"],
        ["--fleet", "prefill=1,decode=1", "--slo-ttft-p95", "0.5"],
        ["--fleet", "prefill=1,decode=1", "--sentinel", "true"],
        # Bounded intake is served now; a load class the prefill buffer
        # cannot hold refuses before the window.
        ["--max-queue", "4", "--loadgen", "rate=8,prompt_max=40"],
    ],
)
def test_later_slice_flags_are_rejected(flags):
    match = (
        "reference" if "reference" in flags
        else "§A 8c" if "--mesh" in flags
        else "fleet's router" if "--fleet" in flags
        else "pass --kv-pages" if "--kv-host-pages" in flags
        else "quantum" if "quantum=0" in flags
        else "prefill-len" if "--max-queue" in flags
        else "max-len"
    )
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", *flags])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_main_paged_cpu_run(kv_dtype):
    """The paged pool through the CLI on the CPU: every request completes,
    and the pool block of the stats is there."""
    flags = ["--kv-dtype", kv_dtype] if kv_dtype else []
    out = main([
        "--device", "cpu", "--model", "tiny", "--requests", "6",
        "--max-new-tokens", "4", "--slots", "2", "--kv-pages", "32",
        "--kv-page-size", "8", "--prefill-chunk", "4", *flags,
    ])
    assert out["requests_completed"] == 6 and out["generated_tokens"] == 24
    assert not out["truncated"] and out["kv_pool_pages"] == 32
    assert out["kv_page_size"] == 8 and out["kv_dtype"] == (kv_dtype or "bf16")
    assert out["obs_summary"]["prefill"]["count"] >= 2


def test_unknown_kv_dtype_is_rejected():
    with pytest.raises(SystemExit, match="f32, bf16 or int8"):
        main(["--device", "cpu", "--kv-dtype", "fp8"])


def test_default_device_is_cuda():
    """Without a GPU the engine and the CLI raise rather than run on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(TCFG, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--requests", "1"])
