"""mpit_tpu_torch's tensor-parallel training tier (the pjit tier, with FSDP)
against mpit_tpu's ``make_pjit_train_step``, on the CPU.

JAX runs its GSPMD step on a ``{"data": 2, "model": 2}`` sub-mesh of the
fake CPU mesh, with and without ``fsdp_axis="data"``; the port runs
:func:`~mpit_tpu_torch.parallel.tp.make_tp_train_step` over a World of
the same axes on the CPU, over :class:`~mpit_tpu_torch.serve.tp.TPGPT2`
with the vocab-cut table, from the same numpy weights and tokens. Tiny
f32 GPT-2 (2 layers, d 32, 2 heads, vocab 128, T 32, batch 4), JAX's
unfused loss (the tier's). Tolerances, with their reasons:

- the specs, leaf for leaf, and the layouts' round trips: exact;
- losses within 1e-5 and the first step's gradients within 2e-6 (f32
  products summed in other orders: XLA's partitioned einsums against the
  port's per-rank matmuls and rank-order sums);
- the parameters after three ``goo_adam`` steps within 1e-5. Adam runs
  with eps 1e-3 on both sides: at optax's 1e-8 it normalises a gradient
  that is zero up to f32 rounding (the key third of ``qkv``'s bias is
  exactly zero) into a step of up to lr in a direction neither side
  controls (``tests/test_torch_dp_train.py``'s reason);
- against the port's one-rank step (the same loss, unsharded): losses
  within 1e-6 and gradients within 1e-6;
- a resumed ``--ckpt-dir`` run equals the uninterrupted one within 1e-6
  relative (JAX's ``TestTierCheckpointing`` pin).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.parallel import tp as jtp
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import gpt2 as tgpt2
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.parallel import tp as ttp
from mpit_tpu_torch.serve import join_gpt2_params, params_from_jax, shard_gpt2_params
from mpit_tpu_torch.serve.tp import TPGPT2
from mpit_tpu_torch.train import make_train_step

jgoo = importlib.import_module("mpit_tpu.opt.goo")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")

LR, EPS = 1e-3, 1e-3
V, T, D, HEADS, LAYERS, B = 128, 32, 32, 2, 2, 4
MESH = {"data": 2, "model": 2}
TINY = ["--batch-size", "8", "--seq-len", "32", "--vocab-size", "128", "--num-layers", "2",
        "--num-heads", "2", "--d-model", "32", "--device", "cpu"]


def _jcfg(vocab=V, heads=HEADS):
    return JConfig.tiny(dtype=jnp.float32, vocab_size=vocab, max_seq_len=T, num_layers=LAYERS,
                        num_heads=heads, d_model=D)


def _tcfg(vocab=V, heads=HEADS):
    return GPT2Config.tiny(dtype=torch.float32, vocab_size=vocab, max_seq_len=T,
                           num_layers=LAYERS, num_heads=heads, d_model=D)


def _batches(vocab=V, n=3):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (B, T + 1)).astype(np.int32) for _ in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keys(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path]


def _name(parts) -> str:
    """A JAX tree path's keys as the port's parameter name."""
    if parts[0].startswith("block_"):
        parts = ["blocks", parts[0][len("block_"):], *parts[1:]]
    return ".".join(parts)


def _jspecs(tree) -> dict:
    """A JAX spec tree as ``{port name: tuple}``."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_name(_keys(path)): tuple(spec) for path, spec in flat}


def _jloss(model):
    def loss_fn(params, batch):
        logits = model.apply({"params": params}, batch["tokens"][:, :-1])
        return JGPT2.loss_fn(logits, batch["tokens"]), {}

    return loss_fn


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's init, its first-step gradients and, with and without FSDP
    over ``data``, three pjit steps: losses and final parameters."""
    world = mpit_tpu.init(MESH, devices=jax.devices()[:4], set_default=False)
    model = JGPT2(_jcfg())
    params = model.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    batches = _batches()
    loss_fn = _jloss(model)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, {"tokens": jnp.asarray(batches[0])})[0]))(params)
    runs = {}
    for fsdp in (None, "data"):
        init_fn, step_fn, _ = jtp.make_pjit_train_step(
            loss_fn, jgoo.goo_adam(LR, eps=EPS), world, jtp.gpt2_tp_rules("model"),
            fsdp_axis=fsdp,
            donate=False,
        )
        state = init_fn(params)
        losses = []
        for tok in batches:
            state, m = step_fn(state, {"tokens": tok})
            losses.append(float(m["loss"]))
        runs[fsdp] = dict(losses=losses, params=params_from_jax(_np(state.params)))
    return _np(params), params_from_jax(_np(grads)), batches, runs


class _Recording:
    """A goo rule that keeps the gradients each step hands it."""

    def __init__(self, inner):
        self.inner, self.grads = inner, []

    def init(self, params):
        return self.inner.init(params)

    def step(self, params, grads, state):
        named = grads.items() if isinstance(grads, dict) else zip(params, grads)
        self.grads.append({k: g.detach().clone() for k, g in named})
        return self.inner.step(params, grads, state)


def _gathered(tree, specs, fsdp_axis):
    """A stored-layout tree with its fsdp shards gathered (the working layout)."""
    if fsdp_axis is None:
        return tree
    return {k: ttp.fsdp_gather(t, specs[k], fsdp_axis=fsdp_axis) for k, t in tree.items()}


def _tp_run(init_state, mesh, batches, *, fsdp_axis=None, vocab=V, heads=HEADS, lr=LR):
    """The port's tier over ``mesh`` from a one-rank state: losses, the
    recorded (stored-layout) gradients, the final state joined, the specs."""
    world = comm.init(mesh, devices=["cpu"])
    m = world.size("model")
    model = TPGPT2(_tcfg(vocab, heads), m, vocab_parallel=True)
    model.load_state_dict(shard_gpt2_params(init_state, m, vocab_parallel=True))

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        return model(tokens[:, :-1], targets=tokens[:, 1:]).mean(), {}

    tx = _Recording(tgoo.goo_adam(lr, eps=EPS))
    init_fn, step_fn, specs_fn = ttp.make_tp_train_step(
        loss_fn, tx, world, ttp.gpt2_tp_rules("model"), fsdp_axis=fsdp_axis
    )
    specs = specs_fn(dict(model.named_parameters()))
    state = init_fn(dict(model.named_parameters()))
    losses = []
    for tok in batches:
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(tok)})
        losses.append(metrics["loss"].item())
    join = lambda tree: join_gpt2_params(  # noqa: E731
        _gathered(tree, specs, fsdp_axis), m, vocab_size=vocab)
    return losses, [join(g) for g in tx.grads], join(state.params), specs, state


def _one_rank_run(init_state, batches, *, vocab=V, heads=HEADS, lr=LR):
    """The port's one-rank step on the same unfused loss."""
    model = GPT2(_tcfg(vocab, heads))
    model.load_state_dict(init_state)
    tx = _Recording(tgoo.goo_adam(lr, eps=EPS))
    init_fn, step_fn = make_train_step(
        lambda p, b: (GPT2.loss_fn(model(b["tokens"].long()[:, :-1]), b["tokens"].long()), {}),
        tx,
    )
    state = init_fn(dict(model.named_parameters()))
    losses = []
    for tok in batches:
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(tok)})
        losses.append(metrics["loss"].item())
    return losses, tx.grads


def _close_params(got, want):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


# -- the specs -----------------------------------------------------------------------


@pytest.mark.parametrize("fsdp_size", [None, 2, 3, 4])
def test_specs_equal_jax(jax_runs, fsdp_size):
    params, *_ = jax_runs
    fsdp = None if fsdp_size is None else "fsdp"
    jp = jtp.param_partition_specs(params, jtp.gpt2_tp_rules("model"), fsdp_axis=fsdp,
                                   fsdp_size=fsdp_size)
    state = params_from_jax(params)
    got = ttp.param_partition_specs(state, ttp.gpt2_tp_rules("model"), fsdp_axis=fsdp,
                                    fsdp_size=fsdp_size)
    assert got == _jspecs(jp)
    assert got["wte"][0] == "model" and got["blocks.0.proj.kernel"][0] == "model"
    # The optimizer's moments follow their parameters, the count replicates.
    jopt = jtp.specs_like_params(jax.eval_shape(jgoo.goo_adam(LR).init, params), params, jp)
    flat = jax.tree_util.tree_flatten_with_path(jopt, is_leaf=lambda x: isinstance(x, P))[0]
    want = {}
    for path, spec in flat:
        keys = _keys(path)
        field = next(k for k in keys if k in ("mu", "nu", "count"))
        if field == "count":
            want["count"] = tuple(spec)
        else:
            want.setdefault(field, {})[_name(keys[keys.index(field) + 1:])] = tuple(spec)
    ospecs = ttp.specs_like_params(tgoo.goo_adam(LR).init(state), state, got)
    assert ospecs == want


def test_fsdp_rules_specs_equal_jax(jax_runs):
    params, *_ = jax_runs
    want = jtp.param_partition_specs(params, jtp.fsdp_rules("fsdp"))
    assert ttp.param_partition_specs(params_from_jax(params), ttp.fsdp_rules("fsdp")) \
        == _jspecs(want)


def test_specs_of_the_working_layout_equal_the_whole_leaves(jax_runs):
    """``specs_fn`` reads the model's own (rank-stacked, vocab-padded)
    parameters and gives the whole leaves' specs; the fsdp cut and its
    gather are inverses."""
    params, *_ = jax_runs
    state = params_from_jax(params)
    world = comm.init({"data": 2, "model": 2}, devices=["cpu"])
    model = TPGPT2(_tcfg(), 2, vocab_parallel=True)
    model.load_state_dict(shard_gpt2_params(state, 2, vocab_parallel=True))
    _, _, specs_fn = ttp.make_tp_train_step(None, None, world, ttp.gpt2_tp_rules(),
                                            fsdp_axis="data")
    specs = specs_fn(dict(model.named_parameters()))
    assert specs == ttp.param_partition_specs(state, ttp.gpt2_tp_rules(), fsdp_axis="data",
                                              fsdp_size=2)
    work = shard_gpt2_params(state, 2, vocab_parallel=True)
    cut = {k: ttp.fsdp_cut(t, specs[k], 2, fsdp_axis="data") for k, t in work.items()}
    assert cut["blocks.0.qkv.kernel"].shape == (2, 2, D // 2, 3 * D // 2)
    assert cut["wte"].shape == (2, 2, V // 2, D // 2)
    back = join_gpt2_params(_gathered(cut, specs, "data"), 2, vocab_size=V)
    assert set(back) == set(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name


# -- the step against JAX's pjit tier -------------------------------------------------


@pytest.mark.parametrize("fsdp", [None, "data"], ids=["tp", "tp_fsdp"])
def test_tp_steps_match_jax_pjit(jax_runs, fsdp):
    params, jgrads, batches, runs = jax_runs
    losses, grads, final, specs, state = _tp_run(params_from_jax(params), MESH, batches,
                                                 fsdp_axis=fsdp)
    np.testing.assert_allclose(losses, runs[fsdp]["losses"], rtol=0, atol=1e-5)
    for name, want in jgrads.items():
        np.testing.assert_allclose(grads[0][name].numpy(), want.numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)
    _close_params(final, runs[fsdp]["params"])
    if fsdp:  # the stored leaves are the fsdp shards; the moments follow them
        assert state.params["blocks.0.fc.kernel"].shape == (2, 2, D // 2, 4 * D // 2)
        assert state.opt_state.mu["blocks.0.fc.kernel"].shape == (2, 2, D // 2, 4 * D // 2)
        assert specs["blocks.0.fc.kernel"] == ("data", "model")


@pytest.mark.parametrize("mesh,fsdp", [({"data": 2, "model": 2}, "data"), ({"model": 2}, None),
                                       ({"fsdp": 2, "model": 2}, "fsdp")],
                         ids=["data2_model2_fsdp", "model2", "fsdp2_model2"])
def test_tp_steps_match_the_one_rank_step(jax_runs, mesh, fsdp):
    params, _, batches, _ = jax_runs
    state = params_from_jax(params)
    losses, grads, *_ = _tp_run(state, mesh, batches, fsdp_axis=fsdp)
    want_losses, want_grads = _one_rank_run(state, batches)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-6)
    for got, want in zip(grads, want_grads):
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)


def test_indivisible_vocab_faults_jax_and_trains_in_the_port():
    """JAX's rule cuts ``wte`` over the vocabulary unpadded: at a
    vocabulary of 130 over 4 model ranks its ``init_fn`` raises (as at
    GPT-2's 50257 over 2 or 4). The port pads the table to 132 rows and
    equals its one-rank step."""
    vocab, heads = 130, 4
    world = mpit_tpu.init({"model": 4}, devices=jax.devices()[:4], set_default=False)
    model = JGPT2(_jcfg(vocab, heads))
    params = model.init(jax.random.key(1), jnp.zeros((1, T), jnp.int32))["params"]
    init_fn, _, _ = jtp.make_pjit_train_step(
        _jloss(model), jgoo.goo_adam(LR), world, jtp.gpt2_tp_rules("model"), donate=False)
    with pytest.raises(ValueError, match="divisible"):
        init_fn(params)
    state = params_from_jax(_np(params))
    batches = _batches(vocab, n=2)
    losses, grads, final, _, tstate = _tp_run(state, {"model": 4}, batches, vocab=vocab,
                                             heads=heads)
    want_losses, want_grads = _one_rank_run(state, batches, vocab=vocab, heads=heads)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-6)
    for name, w in want_grads[0].items():
        np.testing.assert_allclose(grads[0][name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    # The two pad rows: zero, never read, no gradient, no update.
    wte = tstate.params["wte"].reshape(-1, D)
    assert wte.shape[0] == 132 and not wte[vocab:].any()
    assert not tstate.opt_state.mu["wte"].reshape(-1, D)[vocab:].any()


# -- the app tier -----------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--fsdp-axis", "data", "--sentinel", "true"]],
                         ids=["tp", "tp_fsdp"])
def test_app_pjit_tier_trains(extra):
    out = tgpt2.main(["--mesh", "data=2,model=2", "--steps", "8", "--log-every", "4",
                      "--lr", "3e-2", *TINY, *extra])
    assert out["tier"] == "pjit-tp" + ("+fsdp" if extra else "")
    assert out["steps"] == 8 and out["ranks"] == 4
    assert np.isfinite(out["losses"]).all() and out["final_loss"] < out["uniform_loss"]
    assert ("sentinel" in out) == bool(extra)  # the loop's sentinel, on the tier


def test_app_pjit_tier_resume_matches_uninterrupted(tmp_path):
    args = ["--mesh", "data=2,model=2", "--fsdp-axis", "data", "--log-every", "1", *TINY]
    ck = str(tmp_path / "ck")
    first = tgpt2.main(args + ["--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"])
    resumed = tgpt2.main(args + ["--steps", "5", "--ckpt-dir", ck])
    oracle = tgpt2.main(args + ["--steps", "5"])
    assert first["losses"] == oracle["losses"][:3]
    assert len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"], oracle["losses"][-2:], rtol=1e-6)


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--mesh", "data=2,model=2", "--zero1", "false"], "pjit tier ignores --zero1"),
        (["--mesh", "model=2", "--grad-sync", "ring"], "pjit tier ignores it"),
        (["--mesh", "data=2,seq=2", "--grad-sync", "ring_q8"], "cp tier ignores it"),
        (["--mesh", "model=2", "--save-dense", "/s.npz"], "pjit tier ignores them"),
        (["--mesh", "seq=2", "--resume-dense", "/s.npz"], "cp tier ignores them"),
        (["--mesh", "data=2,seq=2", "--fused-loss", "false"], "hardcodes the fused"),
        (["--mesh", "data=2,model=2", "--fsdp-axis", "fsdp"], "not an axis"),
        (["--mesh", "data=2,fsdp=2"], "composes with the model axis"),
        (["--mesh", "data=2,expert=2"], "§A 10"),
        (["--mesh", "seq=2,model=2,pipe=2"], "§A 10"),
    ],
    ids=lambda a: "_".join(a) if isinstance(a, list) else None,
)
def test_tier_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tgpt2.main([*argv, *TINY])
