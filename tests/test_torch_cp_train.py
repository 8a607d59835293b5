"""mpit_tpu_torch's context-parallel tier against mpit_tpu's, on the CPU.

JAX's ring, ring-flash and Ulysses attention run inside ``shard_map`` on
a ``{"seq": S}`` sub-mesh of the fake CPU mesh (S 2 and 4), each device
holding its ``[B, T/S, H, D]`` block; the port's run on the same numpy
inputs rank-stacked ``[S, B, T/S, H, D]``. The ring-flash block runs
JAX's plain XLA path off the TPU and the port's plain versions of the
flash kernels on the CPU: no Pallas interpreter. Then the CP train step
(``make_gpt2_cp_train_step``) of both packages over ``{"data": 2, "seq":
4}`` (the ring, plain and flash) and ``{"data": 4, "seq": 2}`` (Ulysses
with flash), three ``goo_adam`` steps of a tiny f32 GPT-2 from JAX's
init on the same tokens, and the port's app tier. Tolerances:

- attention forward and gradients within 2e-6 (f32; the same online
  softmax, summed in other orders);
- the train step's losses and parameters within rtol/atol 3e-4, the
  pin JAX's own test holds its tier to against one device (Adam at eps
  1e-3 on both sides: at optax's 1e-8 it turns a gradient that is zero
  up to f32 rounding into a step of up to lr);
- a resumed ``--ckpt-dir`` run equals the uninterrupted one within 1e-6
  relative (JAX's ``TestTierCheckpointing`` pin).
"""

from __future__ import annotations

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu.data import shard_batch as j_shard_batch
from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import gpt2 as tgpt2
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.parallel import cp as tcp
from mpit_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from mpit_tpu_torch.parallel.ulysses import ulysses_attention
from mpit_tpu_torch.serve import params_from_jax

jcp = importlib.import_module("mpit_tpu.parallel.cp")
jring = importlib.import_module("mpit_tpu.parallel.ring_attention")
julysses = importlib.import_module("mpit_tpu.parallel.ulysses")
jgoo = importlib.import_module("mpit_tpu.opt.goo")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")

B, T, H, D = 2, 32, 4, 8
LR, EPS = 1e-3, 1e-3
TINY = ["--batch-size", "8", "--seq-len", "32", "--vocab-size", "128", "--num-layers", "2",
        "--num-heads", "2", "--d-model", "32", "--device", "cpu"]

_ATTENTION = {  # name: (JAX function over one device's block, the port's over the stack)
    "ring": (partial(jring.ring_attention, axis="seq"), ring_attention),
    "ring_flash": (partial(jring.ring_flash_attention, axis="seq"), ring_flash_attention),
    "ulysses": (partial(julysses.ulysses_attention, axis="seq"), ulysses_attention),
}


def _stack(x, s):
    """``[B, T, ...]`` → the seq ranks' ``[S, B, T/S, ...]``."""
    return x.unflatten(1, (s, -1)).transpose(0, 1)


def _unstack(x):
    return x.transpose(0, 1).flatten(1, 2)


@pytest.mark.parametrize("s,causal", [(2, True), (4, True), (2, False)],
                         ids=["s2", "s4", "s2_noncausal"])
@pytest.mark.parametrize("name", sorted(_ATTENTION))
def test_attention_matches_jax(name, s, causal):
    jfn, tfn = _ATTENTION[name]
    rng = np.random.default_rng(5 + s)
    q, k, v, w = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    world = mpit_tpu.init({"seq": s}, devices=jax.devices()[:s], set_default=False)
    sharded = jax.jit(world.shard_map(lambda q, k, v: jfn(q, k, v, causal=causal),
                                      in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
                                      check_vma=False))

    def jloss(q, k, v):
        return jnp.sum(sharded(q, k, v) * w)

    want = sharded(q, k, v)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = _unstack(tfn(_stack(tq, s), _stack(tk, s), _stack(tv, s), causal=causal))
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-6)
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0, atol=2e-6)


def test_ulysses_refuses_indivisible_heads():
    q = torch.zeros(4, 1, 2, 2, 8)  # 2 heads over 4 seq ranks
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q)


_CP_CASES = {  # id: (mesh, flash, ulysses)
    "ring": ({"data": 2, "seq": 4}, False, False),
    "ring_flash": ({"data": 2, "seq": 4}, True, False),
    "ulysses_flash": ({"data": 4, "seq": 2}, True, True),
}


@pytest.fixture(scope="module")
def jax_cp_runs():
    """JAX's tiny f32 GPT-2 init, the tokens, and each case's three CP
    steps: losses and final parameters."""
    jcfg = JConfig.tiny(dtype=jnp.float32, num_heads=2, max_seq_len=64)
    params = JGPT2(jcfg).init(jax.random.key(0), jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 64)).astype(np.int32) for _ in range(3)]
    runs = {}
    for case, (mesh, flash, ulysses) in _CP_CASES.items():
        world = mpit_tpu.init(mesh, devices=jax.devices()[:8], set_default=False)
        init_fn, step_fn, _ = jcp.make_gpt2_cp_train_step(
            jcfg, jgoo.goo_adam(LR, eps=EPS), world, flash=flash, ulysses=ulysses, donate=False
        )
        state = init_fn(params)
        losses = []
        for tok in batches:
            state, m = step_fn(state, j_shard_batch(world, {"tokens": tok},
                                                    spec=P("data", "seq")))
            losses.append(float(m["loss"]))
        runs[case] = dict(losses=losses,
                          params=params_from_jax(jax.tree.map(np.asarray, state.params)))
    return params_from_jax(jax.tree.map(np.asarray, params)), batches, runs


@pytest.mark.parametrize("case", sorted(_CP_CASES))
def test_cp_steps_match_jax(jax_cp_runs, case):
    init, batches, runs = jax_cp_runs
    mesh, flash, ulysses = _CP_CASES[case]
    cfg = GPT2Config.tiny(dtype=torch.float32, num_heads=2, max_seq_len=64)
    world = comm.init(mesh, devices=["cpu"])
    init_fn, step_fn, _ = tcp.make_gpt2_cp_train_step(
        cfg, tgoo.goo_adam(LR, eps=EPS), world, flash=flash, ulysses=ulysses
    )
    state = init_fn(init)
    losses = []
    for tok in batches:
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(tok)})
        losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, runs[case]["losses"], rtol=3e-4, atol=3e-4)
    assert state.replicas_equal()
    got = dict(step_fn.models[0].named_parameters())
    for name, want in runs[case]["params"].items():
        np.testing.assert_allclose(got[name].detach().numpy(), want.numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


def test_cp_zero1_false_sums_over_data_as_zero1_does():
    """``zero1=False`` sums the data ranks' gradients (JAX's psum over
    ``data``) where ZeRO-1 reduce-scatters the same sum: the same
    trajectory within f32 rounding; the state specs name the cut."""
    cfg = GPT2Config.tiny(dtype=torch.float32, num_heads=2, max_seq_len=64)
    init = {k: v.detach().clone() for k, v in
            GPT2(cfg, generator=torch.Generator().manual_seed(0)).state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 4, 64)))
    world = comm.init({"data": 2, "seq": 2}, devices=["cpu"])
    losses = {}
    for zero1 in (True, False):
        init_fn, step_fn, specs = tcp.make_gpt2_cp_train_step(
            cfg, tgoo.goo_adam(LR, eps=EPS), world, flash=True, zero1=zero1)
        state = init_fn(init)
        losses[zero1] = [step_fn(state, {"tokens": t})[1]["loss"].item() for t in tokens]
        assert specs(init)["opt_state"] == (("data",) if zero1 else ())
        assert set(specs(init)["params"].values()) == {()}
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-6)


@pytest.mark.parametrize("mesh,extra,tier", [
    ("data=2,seq=4", ["--flash", "true"], "cp-ring-flash"),
    ("data=4,seq=2", ["--ulysses", "true"], "cp-ulysses"),
], ids=["ring_flash", "ulysses"])
def test_app_cp_tier_trains(mesh, extra, tier, tmp_path):
    out = tgpt2.main(["--mesh", mesh, "--steps", "8", "--log-every", "4", "--lr", "3e-2",
                      "--profile-dir", str(tmp_path), *TINY, *extra])
    assert out["tier"] == tier and out["steps"] == 8 and out["ranks"] == 8
    assert np.isfinite(out["losses"]).all() and out["final_loss"] < out["uniform_loss"]
    assert (tmp_path / "trace.json").exists() and out["profile"]  # the loop's window


def test_app_cp_tier_resume_matches_uninterrupted(tmp_path):
    args = ["--mesh", "data=2,seq=2", "--log-every", "1", *TINY]
    ck = str(tmp_path / "ck")
    first = tgpt2.main(args + ["--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"])
    resumed = tgpt2.main(args + ["--steps", "5", "--ckpt-dir", ck])
    oracle = tgpt2.main(args + ["--steps", "5"])
    assert first["losses"] == oracle["losses"][:3]
    assert len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"], oracle["losses"][-2:], rtol=1e-6)
