"""mpit_tpu_torch GPT-2 against the JAX package's, on the same weights.

The JAX param tree goes through ``params_from_jax`` (the only way the
two packages share weights); inputs are made by numpy from a seed. All
comparisons run the tiny config in float32 and hold within
``atol = rtol = 1e-4``: XLA and PyTorch sum the matmuls and LayerNorm
statistics in different orders on the CPU, so the last bits differ,
and two layers of that stay well inside 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.ops.decode_attention import flash_decode_attention as j_flash
from mpit_tpu.serve import alloc_cache as j_alloc_cache
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.ops import flash_decode_attention
from mpit_tpu_torch.serve import (
    alloc_cache,
    infer_config,
    load_gpt2_params,
    params_from_jax,
    validate_params,
)

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = JConfig.tiny(dtype=jnp.float32)
SLOTS, MAX_LEN, PLEN = 2, 32, 8


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) on the same weights."""
    jmodel = JGPT2(JCFG)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape)


def test_uncached_forward_logits(pair):
    jmodel, params, tmodel = pair
    toks = _tokens((2, 12), 0).astype(np.int32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attention", ["plain", "kernel-wrapper"])
def test_prefill_then_three_decode_ticks(pair, attention):
    """The cache path: a padded prefill from length 0, then three
    single-token decode ticks at ragged lengths, hiddens and caches held
    against JAX after every step. ``kernel-wrapper`` routes the port's
    attention through ``flash_decode_attention`` (its plain version on
    the CPU), as the engine does."""
    _, params, tmodel = pair
    if attention == "kernel-wrapper":
        cfg = GPT2Config.tiny(
            dtype=torch.float32, cache_attention_fn=flash_decode_attention
        )
        tmodel2 = GPT2(cfg, device="cpu")
        tmodel2.load_state_dict(tmodel.state_dict())
        tmodel = tmodel2
    # The JAX side runs its flash-decode entry point (its reference path
    # on the CPU), as the JAX engine does.
    jflash = JGPT2(dataclasses.replace(JCFG, cache_attention_fn=j_flash))
    jfwd = jax.jit(
        lambda p, toks, c: jflash.apply(
            {"params": p}, toks, cache=c, return_hidden=True
        )
    )
    jc = j_alloc_cache(JCFG, SLOTS, MAX_LEN)
    jk, jv = jc.k, jc.v
    tc = alloc_cache(tmodel.cfg, SLOTS, MAX_LEN, device="cpu")

    def step(toks, lengths):
        nonlocal jk, jv
        hj, (jk, jv) = jfwd(
            params, jnp.asarray(toks, jnp.int32),
            (jk, jv, jnp.asarray(lengths, jnp.int32)),
        )
        with torch.no_grad():
            ht, _ = tmodel(
                torch.from_numpy(toks).long(),
                cache=(tc.k, tc.v, torch.from_numpy(lengths).int()),
                return_hidden=True,
            )
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)

    step(_tokens((SLOTS, PLEN), 1), np.zeros(SLOTS, np.int32))
    lengths = np.asarray([5, PLEN], np.int32)  # ragged prompt lengths
    for tick in range(3):
        step(_tokens((SLOTS, 1), 2 + tick), lengths)
        lengths = lengths + 1
        for i in range(SLOTS):  # the rows attention can see
            n = int(lengths[i])
            np.testing.assert_allclose(
                tc.k[:, i, :n].numpy(), np.asarray(jk[:, i, :n]), **TOL
            )
            np.testing.assert_allclose(
                tc.v[:, i, :n].numpy(), np.asarray(jv[:, i, :n]), **TOL
            )


def test_dense_npz_round_trip(pair, tmp_path):
    """A ``save_dense`` file from the JAX package loads with numpy only
    into the same state and geometry."""
    from mpit_tpu.train.convert import DenseState, save_dense

    _, params, tmodel = pair
    path = str(tmp_path / "dense.npz")
    save_dense(
        path, DenseState(step=3, params=params, moments=[], scalars=[]),
        num_heads=JCFG.num_heads, tie_head=True,
    )
    state, cfg = load_gpt2_params(path)
    assert (cfg.vocab_size, cfg.max_seq_len, cfg.num_layers, cfg.num_heads,
            cfg.d_model, cfg.ff_dim, cfg.tie_head) == (
        JCFG.vocab_size, JCFG.max_seq_len, JCFG.num_layers, JCFG.num_heads,
        JCFG.d_model, JCFG.ff_dim, JCFG.tie_head)
    want = tmodel.state_dict()
    assert state.keys() == want.keys()
    for key in want:
        assert torch.equal(state[key], want[key]), key


def test_infer_and_validate_config(pair):
    _, params, _ = pair
    cfg = infer_config(params, num_heads=JCFG.num_heads)
    validate_params(cfg, params)
    bad = {**params, "wpe": np.zeros((7, JCFG.d_model), np.float32)}
    with pytest.raises(ValueError, match="shape-mismatch"):
        validate_params(cfg, bad)
