"""mpit_tpu_torch's EASGD under the SPMD step (``opt/goo.py``'s
``elastic_average`` and ``chain``, its ZeRO-1 form in ``opt/sharded.py``,
``asyncsgd/runner.py::build_tx``) against mpit_tpu's, on the CPU.

The JAX side runs once, in a module fixture: LeNet on synthetic MNIST
(32 images a step), ``optax.chain(goo(0.05, 0.9),
elastic_average(0.125, axis="data"))`` through ``make_train_step`` for
five steps on the fake CPU mesh, at p 1 (``zero1`` true and false) and
p 4 (``zero1`` false, and true to show the reference's fault).
Tolerances, with their reasons:

- the transform alone at p 1 (one worker, a vector and its gradients
  made by numpy): parameters and centre within 1e-6 of JAX's (XLA may
  contract ``u - α·(p - c)`` into one FMA; the port rounds twice);
- LeNet: losses within 1e-5 relative and the centre within 1e-5
  absolute of JAX's ``zero1=False`` (XLA and PyTorch sum the
  convolutions' gradients in other orders, as in
  ``test_torch_convnets.py``); at p 1 both JAX paths agree and the port
  is held against both;
- the port's ``zero1`` true and false: losses, parameters and centre
  equal bit for bit through ``psum`` and ``ring`` (every element's mean
  adds the same values in rank order on both paths); through
  ``ring_q8``, whose ZeRO-1 form gathers int8 updates where plain DP
  gathers int8 gradients, losses within ``0.02 + 0.02·|loss|`` (the
  JAX package's q8 pin) and the replicas bit-identical;
- the reference's fault: JAX's ``zero1=True`` centre at p 4 is more
  than 1e-3 away from its ``zero1=False`` centre (its ``pmean`` of the
  devices' shards averages different parameters), while the port's
  forms are equal. If a later JAX fixes it, this test says so.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu
from mpit_tpu.asyncsgd import runner as jrunner
from mpit_tpu.data import shard_batch as j_shard_batch
from mpit_tpu.models import LeNet as JLeNet
from mpit_tpu.train import make_train_step as j_make_train_step
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import mnist, runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig
from mpit_tpu_torch.data import shard_batch, synthetic_mnist
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.models.layers import params_from_jax
from mpit_tpu_torch.opt import ElasticState, chain, elastic_average, goo
from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
from mpit_tpu_torch.train import (
    CheckpointManager, dense_from_dp, dp_from_dense, hardened_loop, make_train_step,
)
from mpit_tpu_torch.train.convert import flat_unravel

jgoo = importlib.import_module("mpit_tpu.opt.goo")

LR, MOM, ALPHA, STEPS = 0.05, 0.9, 0.125, 5
CPU = ["--device", "cpu"]


def _batches(n=STEPS, bs=32):
    stream = synthetic_mnist(seed=0).batches(bs)
    return [next(stream) for _ in range(n)]


def _jtx(axis="data"):
    return optax.chain(jgoo.goo(LR, MOM), jgoo.elastic_average(ALPHA, axis=axis))


def _ttx():
    return chain(goo(LR, MOM), elastic_average(ALPHA, axis="data"))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's losses and flat centre (the port's flat layout, padded for
    p) for each (p, zero1), from one set of initial parameters."""
    jmodel = JLeNet()
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])

    def loss_fn(p, b):
        return jrunner.softmax_xent(jmodel.apply({"params": p}, b["image"]), b["label"]), {}

    out = {}
    for p, zero1 in [(1, True), (1, False), (4, False), (4, True)]:
        world = mpit_tpu.init({"data": p}, devices=jax.devices()[:p], set_default=False)
        init_fn, step_fn, _ = j_make_train_step(loss_fn, _jtx(), world, zero1=zero1,
                                                grad_sync="psum", donate=False)
        state = init_fn(jax.tree.map(jnp.asarray, params))
        losses = []
        for b in _batches():
            state, m = step_fn(state, j_shard_batch(world, b))
            losses.append(float(m["loss"]))
        center = jax.tree.map(np.asarray, state.opt_state[1].center)
        if zero1:  # JAX's global flat vector of the p shards, its layouts (HWIO)
            center = flat_unravel(center, params)
        named = params_from_jax(center, LeNet())
        out[(p, zero1)] = (losses, FlatLayout(named).ravel(named).numpy())
    return params, out


def _flat_center(state):
    """The port's centre as one flat vector: rank 0's row of the plain
    DP ``[p, N]`` centre, or the ZeRO-1 ``[p, S]`` shards end to end."""
    center = state.opt_state[1].center
    if isinstance(center, dict):  # one rank: name -> tensor
        named = {n: t.detach() for n, t in center.items()}
        return FlatLayout(named).ravel(named).numpy()
    (c,) = center
    return (c[0] if state.flat is not None and c.shape == state.flat.params.shape
            else c.reshape(-1)).numpy()


def _port_run(params, p, *, zero1=True, mode="psum", batches=None):
    models = [LeNet() for _ in range(p)]
    for m in models:
        m.load_state_dict(params_from_jax(params, m))
    fns = [runner._classifier_fns(m, top5=False)[0] for m in models]
    world = None if p == 1 else comm.init({"data": p}, devices=["cpu"])
    init_fn, step_fn = make_train_step(fns[0] if world is None else fns, _ttx(), world,
                                       zero1=zero1, grad_sync=mode)
    named = [dict(m.named_parameters()) for m in models]
    state = init_fn(named[0] if world is None else named)
    losses = []
    for b in batches or _batches():
        if world is None:
            b = {k: torch.from_numpy(v) for k, v in b.items()}
        state, m = step_fn(state, b if world is None else shard_batch(world, b))
        losses.append(m["loss"].item())
    return losses, state


def _close_to_jax(got_flat, want_flat, atol):
    n = min(got_flat.shape[0], want_flat.shape[0])
    np.testing.assert_allclose(got_flat[:n], want_flat[:n], rtol=0, atol=atol)
    assert not np.any(got_flat[n:]) and not np.any(want_flat[n:])  # the pads stay zero


def test_elastic_transform_equals_jax_at_one_worker():
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(300).astype(np.float32)
    grads = rng.standard_normal((6, 300)).astype(np.float32)
    jtx = _jtx(axis=None)
    jw = jnp.asarray(w0)
    jst = jtx.init(jw)
    for g in grads:
        u, jst = jtx.update(jnp.asarray(g), jst, jw)
        jw = optax.apply_updates(jw, u)
    ttx = chain(goo(LR, MOM), elastic_average(ALPHA))
    tw = {"w": torch.from_numpy(w0.copy())}
    tst = ttx.init(tw)
    for g in grads:
        ttx.step(tw, (torch.from_numpy(g),), tst)
    assert isinstance(tst[1], ElasticState)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tst[1].center["w"].numpy(), np.asarray(jst[1].center),
                               rtol=0, atol=1e-6)


def test_beta_defaults_to_alpha_and_params_are_required():
    tx = elastic_average(0.3)
    assert tx.beta == 0.3 and elastic_average(0.3, 0.5).beta == 0.5
    with pytest.raises(ValueError, match="requires params"):
        tx.update([torch.zeros(2)], tx.init([torch.zeros(2)]))


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "dp"])
def test_lenet_one_rank_equals_both_jax_paths(jax_runs, zero1):
    params, runs = jax_runs
    losses, state = _port_run(params, 1)
    want_losses, want_center = runs[(1, zero1)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    _close_to_jax(_flat_center(state), want_center, 1e-5)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("zero1,mode", [(True, "psum"), (False, "psum"), (True, "ring")])
def test_lenet_four_ranks_equals_jax_plain_dp(jax_runs, zero1, mode):
    params, runs = jax_runs
    losses, state = _port_run(params, 4, zero1=zero1, mode=mode)
    want_losses, want_center = runs[(4, False)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    _close_to_jax(_flat_center(state), want_center, 1e-5)
    assert state.replicas_equal() and losses[-1] < losses[0]


@pytest.mark.parametrize("mode", ["psum", "ring"])
def test_zero1_forms_bit_equal(jax_runs, mode):
    params, _ = jax_runs
    l1, s1 = _port_run(params, 4, zero1=True, mode=mode)
    l0, s0 = _port_run(params, 4, zero1=False, mode=mode)
    assert l1 == l0
    assert torch.equal(s1.flat.params, s0.flat.params)
    assert np.array_equal(_flat_center(s1), _flat_center(s0))
    assert s1.opt_state[1].center[0].shape == (4, s1.flat.params.shape[1] // 4)


def test_zero1_forms_ring_q8_within_the_q8_pin(jax_runs):
    params, _ = jax_runs
    l1, s1 = _port_run(params, 4, zero1=True, mode="ring_q8")
    l0, s0 = _port_run(params, 4, zero1=False, mode="ring_q8")
    lp, _ = _port_run(params, 4, zero1=False, mode="psum")
    for got in (l1, l0):
        np.testing.assert_allclose(got, lp, rtol=0.02, atol=0.02)
    assert s1.replicas_equal() and s0.replicas_equal()
    assert np.isfinite(_flat_center(s1)).all() and np.isfinite(_flat_center(s0)).all()


def test_reference_zero1_centre_fault_shown(jax_runs):
    """JAX's ``sharded()`` hands ``elastic_average`` one shard per device,
    whose ``pmean`` then averages different parameters (and zero pads):
    at p 4 its ZeRO-1 centre leaves its plain-DP centre. The port's two
    forms agree bit for bit (``test_zero1_forms_bit_equal``)."""
    params, runs = jax_runs
    _, z1 = runs[(4, True)]
    _, dp = runs[(4, False)]
    n = min(z1.shape[0], dp.shape[0])
    gap = float(np.abs(z1[:n] - dp[:n]).max())
    assert gap > 1e-3, f"JAX's ZeRO-1 centre is within {gap} of its plain-DP one: fixed?"
    _, s1 = _port_run(params, 4, zero1=True)
    _close_to_jax(_flat_center(s1), dp, 1e-5)


def _lenet_loop(p, batches, *, ckpt=None, steps, seed=0):
    world = comm.init({"data": p}, devices=["cpu"])
    init = LeNet(generator=torch.Generator().manual_seed(seed)).state_dict()
    models = [LeNet() for _ in range(p)]
    for m in models:
        m.load_state_dict(init)
    fns = [runner._classifier_fns(m, top5=False)[0] for m in models]
    init_fn, step_fn = make_train_step(fns, _ttx(), world)
    st = init_fn([dict(m.named_parameters()) for m in models])
    if ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(st)
    return hardened_loop(st, step_fn, iter(batches[st.step:]), steps=steps, device="cpu",
                         log_every=1, ckpt=ckpt, world=world)


def test_resumed_easgd_run_bit_equal(tmp_path):
    batches = _batches(n=6)
    full = _lenet_loop(4, batches, steps=6)
    ck = CheckpointManager(tmp_path)
    first = _lenet_loop(4, batches, ckpt=ck, steps=3)
    ck.save(3, first["state"])
    ck.wait()
    rest = _lenet_loop(4, batches, ckpt=ck, steps=6, seed=1)
    assert first["losses"] + rest["losses"] == full["losses"]
    a, b = full["state"], rest["state"]
    assert torch.equal(a.flat.params, b.flat.params) and b.replicas_equal()
    assert torch.equal(a.opt_state[1].center[0], b.opt_state[1].center[0])
    assert torch.equal(a.opt_state[0].momentum[0], b.opt_state[0].momentum[0])


def test_dense_carries_the_centre_as_a_moment(tmp_path):
    """JAX's ``dense_from_dp`` takes every vector leaf of the chained
    state: the momentum, then the centre. A p 4 state's dense file
    restores into p 2 with both."""
    params = jax.tree.map(np.asarray, jax.jit(JLeNet().init)(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])
    tx = _ttx()
    _, s4 = _port_run(params, 4)
    dense = dense_from_dp(s4, tx)
    assert len(dense.moments) == 2 and dense.scalars == []
    _, s2 = _port_run(params, 2, batches=_batches(n=1))
    dp_from_dense(dense, s2, tx)
    n = s4.flat.layout.total
    assert torch.equal(s2.flat.params[0, :n], s4.flat.params[0, :n])
    assert np.array_equal(_flat_center(s2)[:n], _flat_center(s4)[:n])
    assert s2.opt_state[1].center[0].shape == (2, padded_len(n, 2) // 2)


def test_build_tx_chains_under_easgd():
    cfg = TrainConfig(easgd=True, easgd_alpha=0.2)
    tx = runner.build_tx(cfg, axis="data")
    assert tx.txs[1].alpha == 0.2 and tx.txs[1].axis == "data"
    assert not hasattr(runner.base_tx(cfg), "txs")
    assert runner.run_meta(cfg)["easgd_alpha"] == 0.2


def test_cli_easgd_four_ranks_no_longer_refused():
    args = ["--easgd", "true", "--mesh", "data=4", "--steps", "12", "--batch-size", "32",
            "--log-every", "1", *CPU]
    on = mnist.main(args)
    off = mnist.main([*args, "--zero1", "false"])
    assert on["losses"] == off["losses"] and on["replicas_identical"]
    assert np.mean(on["losses"][-3:]) < np.mean(on["losses"][:3])
