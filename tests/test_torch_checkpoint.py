"""mpit_tpu_torch's checkpoints, the loop's recovery and the dense
cross-geometry format against mpit_tpu's, on the CPU.

- ``AtomicCheckpoint`` and ``CheckpointManager``: the round trip, the
  prune, torn temp files unseen, a failed write leaving the prior
  checkpoint, the asynchronous save's snapshot (exact);
  ``ensure_meta``'s drift error, deferred merge and warnings against
  JAX's manager on the same sequence (the same files, messages and
  warnings, the directory's name aside);
- ``run_meta``: equal to JAX's for the same flags (gpt2: JAX's minus the
  fields of its other tiers, which the port's config does not have);
- ``hardened_loop``'s bookkeeping against JAX's: both loops driven by a
  scripted step whose losses come from one table (NaNs at chosen
  batches, a SIGTERM at a chosen step) and one recording checkpoint:
  the same saves, restore targets, restores, logged records and raise
  (exact: no arithmetic is compared);
- resume: a run stopped and resumed (by a checkpoint, by a SIGTERM)
  equals the run that was never stopped bit for bit, at one rank and at
  p 4 (ZeRO-1, ``psum`` and ``ring``), the p 4 restore written into the
  bound state with the replicas equal, and a ResNet's BatchNorm buffers
  carried; a poisoned loss restores, twice past ``--max-restores``
  raises;
- the dense ``.npz``: the port's ``save_dense`` of a state converted
  from JAX equals JAX's key for key, in JAX's order and dtypes, bit for
  bit (tiny GPT-2 under Adam with a schedule, LeNet under goo momentum);
  a JAX-written file resumes in the port (at p 4) and a port-written
  one in JAX (at p 2), the two continuations within 1e-5 of each other
  (XLA and PyTorch sum the matmuls and LayerNorm statistics in other
  orders, as ``tests/test_torch_dp_train.py`` states); the p 4 → 2
  rescale within JAX's own pin (``rtol 2e-5, atol 2e-6``,
  ``tests/test_convert.py``); the restore-source resolution
  (``tests/test_guard.py``'s sequence); a port-trained GPT-2 served by
  ``serve --ckpt``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu.asyncsgd import config as jconfig
from mpit_tpu.asyncsgd import gpt2 as jgpt2_app
from mpit_tpu.asyncsgd import imagenet as jimagenet_app
from mpit_tpu.asyncsgd import resnet as jresnet_app
from mpit_tpu.asyncsgd import runner as jrunner
from mpit_tpu.data import shard_batch as j_shard_batch
from mpit_tpu.models import LeNet as JLeNet
from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.train import CheckpointManager as JCheckpointManager
from mpit_tpu.train import TrainState as JTrainState
from mpit_tpu.train import dense_from_dp as j_dense_from_dp
from mpit_tpu.train import dp_from_dense as j_dp_from_dense
from mpit_tpu.train import hardened_loop as j_hardened_loop
from mpit_tpu.train import load_dense as j_load_dense
from mpit_tpu.train import make_train_step as j_make_train_step
from mpit_tpu.train import save_dense as j_save_dense
from mpit_tpu.train.guard import Diverged as JDiverged
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import gpt2, imagenet, mnist, resnet, runner
from mpit_tpu_torch.asyncsgd.config import TrainConfig, from_argv
from mpit_tpu_torch.data import shard_batch, synthetic_mnist
from mpit_tpu_torch.models import GPT2, GPT2Config, LeNet
from mpit_tpu_torch.models.layers import params_from_jax as conv_params_from_jax
from mpit_tpu_torch.opt import goo, goo_adam, schedules
from mpit_tpu_torch.train import (
    AtomicCheckpoint,
    CheckpointManager,
    Diverged,
    TrainState,
    dense_from_dp,
    dp_from_dense,
    hardened_loop,
    load_dense,
    make_train_step,
    save_dense,
    train_state_from_jax,
)

jgoo = importlib.import_module("mpit_tpu.opt.goo")
jschedules = importlib.import_module("mpit_tpu.opt.schedules")

CPU = ["--device", "cpu"]
MNIST = ["--batch-size", "32", "--log-every", "1", "--lr", "0.05", *CPU]


def _state(step: int, fill: float) -> TrainState:
    """A one-rank state with a goo momentum buffer and a count."""
    params = {"b": torch.full((3,), fill), "a": torch.full((16,), fill)}
    opt = goo(lambda c: 0.1, 0.9).init(params)
    for t in opt.momentum.values():
        t.fill_(2 * fill)
    opt.count = step
    return TrainState(step=step, params=params, opt_state=opt)


# ---- AtomicCheckpoint and CheckpointManager -----------------------------------


def test_atomic_roundtrip_prune_and_torn_files(tmp_path):
    ck = AtomicCheckpoint(tmp_path, max_to_keep=2)
    assert ck.latest_step() is None
    for s in (5, 10, 15):
        ck.save(s, _state(s, s))
    assert ck.all_steps() == [10, 15]  # pruned to max_to_keep
    like = _state(0, 0)
    keep = like.params["a"]
    out = ck.restore(like)
    assert out is like and out.step == 15 and out.opt_state.count == 15
    assert out.params["a"] is keep  # written into the state's own tensor
    assert torch.equal(out.params["a"], torch.full((16,), 15.0))
    assert torch.equal(out.opt_state.momentum["b"], torch.full((3,), 30.0))
    assert ck.restore(_state(0, 0), step=10).step == 10
    # Debris a kill mid-write would leave, and a foreign file: unseen.
    (tmp_path / ".tmp-step_0000000099-999.npz").write_bytes(b"torn!")
    (tmp_path / "step_junk.npz").write_bytes(b"not ours")
    assert ck.all_steps() == [10, 15]
    # The leaf order is documented: step, params, the goo fields, extra.
    with np.load(tmp_path / "step_0000000015.npz") as z:
        assert z.files == [f"leaf_{i:04d}" for i in range(6)]
        assert [z[f"leaf_{i:04d}"].shape for i in range(6)] == [(), (16,), (3,), (16,), (3,), ()]
    # Structure drift: another number of leaves, or another shape.
    with pytest.raises(ValueError, match="structure drift"):
        ck.restore(TrainState(step=0, params={"a": torch.zeros(16)}, opt_state=None))
    bad = _state(0, 0)
    bad.params["a"] = torch.zeros(17)
    with pytest.raises(ValueError, match="structure drift"):
        ck.restore(bad)


def test_atomic_failed_write_leaves_prior_checkpoint(tmp_path, monkeypatch):
    ck = AtomicCheckpoint(tmp_path)
    ck.save(5, _state(5, 1))

    def dying_savez(f, **kw):
        f.write(b"partial bytes")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(RuntimeError, match="killed mid-write"):
        ck.save(10, _state(10, 2))
    monkeypatch.undo()
    assert ck.all_steps() == [5]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000005.npz"]
    assert ck.restore(_state(0, 0)).step == 5


def test_manager_async_snapshot_wait_and_max_to_keep(tmp_path):
    with CheckpointManager(tmp_path, max_to_keep=2) as ck:
        state = _state(1, 1.0)
        for s in (1, 2, 3):
            state.step = s
            ck.save(s, state)
            # The step updates in place right after the save returns: the
            # file must hold the state from before.
            state.params["a"].add_(100.0)
        assert ck.all_steps()[-1] == 3  # being written counts
        ck.wait()
        assert ck.all_steps() == [2, 3]
        out = ck.restore(_state(0, 0))
        assert out.step == 3 and torch.equal(out.params["a"], torch.full((16,), 201.0))
    sync = CheckpointManager(tmp_path / "sync", async_save=False, max_to_keep=1)
    sync.save(7, _state(7, 7.0))
    assert sync.all_steps() == [7]
    assert sync.restore(_state(0, 0), step=7).params["b"][0] == 7.0


def _meta_sequence(make, tmp_path, save, restore):
    """The same ensure_meta sequence on either package's manager:
    returns what each step left (files, warnings, errors), the
    directory's name replaced by ``<dir>``."""
    d = str(tmp_path.absolute())
    meta_path = tmp_path / "run_meta.json"
    m1 = {"lr": 0.05, "batch_size": 32, "seed": 0}
    log = []

    def record(label, fn):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                fn()
                err = None
            except ValueError as e:
                err = str(e).replace(d, "<dir>")
        log.append((label, err, [str(x.message).replace(d, "<dir>") for x in w],
                    json.loads(meta_path.read_text()) if meta_path.exists() else None))

    ck = make()
    record("fresh", lambda: ck.ensure_meta(m1))
    save(ck, 1)
    ck = make()
    record("same", lambda: ck.ensure_meta(m1))
    record("drift", lambda: make().ensure_meta({**m1, "lr": 0.1}))
    ck = make()
    record("unrecorded default",
           lambda: ck.ensure_meta({**m1, "augment": False}, defaults={"augment": False}))
    record("merge after restore", lambda: restore(ck))
    ck = make()
    record("unrecorded non-default",
           lambda: ck.ensure_meta({**m1, "augment": False, "crop_pad": 8},
                                  defaults={"crop_pad": 4}))
    record("merge after a durable save", lambda: save(ck, 2))
    meta_path.unlink()
    record("no run_meta.json", lambda: make().ensure_meta(m1))
    return log


def test_ensure_meta_sequence_equals_jax(tmp_path):
    jworld = mpit_tpu.init()
    jstate = {"a": jnp.zeros(4)}

    def jsave(ck, step):
        ck.save(step, jstate)
        ck.wait()

    want = _meta_sequence(lambda: JCheckpointManager(tmp_path / "jax", jworld),
                          tmp_path / "jax", jsave,
                          lambda ck: ck.restore(jstate, {"a": P()}))
    tstate = TrainState(step=0, params={"a": torch.zeros(4)}, opt_state=None)

    def tsave(ck, step):
        ck.save(step, tstate)
        ck.wait()

    got = _meta_sequence(lambda: CheckpointManager(tmp_path / "port"), tmp_path / "port",
                         tsave, lambda ck: ck.restore(tstate))
    assert got == want
    labels = {label: (err, ws) for label, err, ws, _ in got}
    assert "different geometry" in labels["drift"][0]
    assert any("predates geometry" in w for w in labels["unrecorded non-default"][1])
    assert any("no run_meta.json" in w for w in labels["no run_meta.json"][1])


# ---- run_meta --------------------------------------------------------------------

_META_CASES = {  # id: (JAX config class, port config class, argv)
    "mnist_default": (jconfig.TrainConfig, TrainConfig, []),
    "mnist_flags": (jconfig.TrainConfig, TrainConfig, [
        "--schedule", "warmup_cosine", "--warmup-steps", "5", "--lr-end-scale", "0.1",
        "--grad-sync", "ring_q8", "--grad-bucket-mb", "2", "--easgd", "true",
        "--easgd-alpha", "0.2", "--augment", "true", "--crop-pad", "2", "--seed", "3",
        "--data-dir", "some/dir", "--momentum", "0.5", "--weight-decay", "1e-4"]),
    "imagenet_step": (jimagenet_app.ImagenetConfig, imagenet.ImagenetConfig, [
        "--schedule", "step", "--decay-every", "10", "--image-size", "64"]),
    "resnet": (jresnet_app.ResnetConfig, resnet.ResnetConfig, ["--bn-impl", "flax"]),
    "gpt2": (jgpt2_app.GPT2TrainConfig, gpt2.GPT2TrainConfig, [
        "--num-layers", "2", "--flash", "true", "--schedule", "warmup", "--warmup-steps", "3"]),
}


@pytest.mark.parametrize("case", sorted(_META_CASES))
def test_run_meta_equals_jax(case):
    jcls, tcls, argv = _META_CASES[case]
    want = jrunner.run_meta(jconfig.from_argv(jcls, argv))
    got = runner.run_meta(from_argv(tcls, argv, later=runner.LATER_FLAGS))
    if case == "gpt2":  # the fields of JAX's other tiers (PP, EP)
        others = {"microbatches", "pp_schedule", "pp_chunks", "moe_experts", "moe_k",
                  "moe_capacity", "moe_every", "aux_weight"}
        assert set(want) - set(got) == others
        want = {k: v for k, v in want.items() if k not in others}
    assert got == want
    assert got["stream_impl"] == "python"


# ---- the loop's bookkeeping against JAX's ------------------------------------------


class _RecordingCkpt:
    """One checkpoint stand-in for both loops: records every save, wait
    and restore; a restore sets the state's step to the target."""

    def __init__(self):
        self.steps: list[int] = []
        self.calls: list[tuple] = []

    def save(self, step, state):
        self.calls.append(("save", step, int(state.step)))
        if step not in self.steps:
            self.steps.append(step)

    def restore(self, state, specs=None, *, step=None):
        self.calls.append(("restore", step))
        if isinstance(state, JTrainState):
            return state._replace(step=jnp.asarray(step, jnp.int32))
        state.step = step
        return state

    def all_steps(self):
        return sorted(self.steps)

    def latest_step(self):
        return max(self.steps) if self.steps else None

    def wait(self):
        self.calls.append(("wait",))


class _Log:
    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append((step, json.dumps(metrics, sort_keys=True)))


_LOOP_CASES = {  # id: (loop keywords, NaN batches, SIGTERM at this batch)
    "lag2_restore": (dict(log_every=1, fetch_lag=2, ckpt_every=4, max_restores=1), {9}, None),
    "lag1_backoff": (dict(log_every=1, fetch_lag=1, ckpt_every=3, max_restores=3),
                     {7, 9}, None),
    "sync_raise": (dict(log_every=1, fetch_lag=0, ckpt_every=5, max_restores=1), {7, 12}, None),
    "no_candidate": (dict(log_every=1, fetch_lag=2, ckpt_every=6, max_restores=2), {3}, None),
    "final_save": (dict(log_every=3, fetch_lag=2, ckpt_every=4, final_save=True), set(), None),
    "preempt": (dict(log_every=1, fetch_lag=2, ckpt_every=4, max_restores=1), {9}, 14),
}


def _scripted(nan_at, term_at, make_loss, make_state):
    def step_fn(state, batch):
        i = int(batch["i"][0])
        if i == term_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return make_state(state), {"loss": make_loss(float("nan") if i in nan_at else 1.0 / (i + 1))}

    return step_fn


def _batches():
    return iter({"i": np.full((8,), i, np.int32)} for i in range(1000))


def _drive(loop, kw, nan_at, term_at, jax_side: bool):
    ck, log = _RecordingCkpt(), _Log()
    if jax_side:
        state = JTrainState(step=jnp.asarray(0, jnp.int32), params={}, opt_state=(), extra=())
        step_fn = _scripted(nan_at, term_at, jnp.float32,
                            lambda s: s._replace(step=s.step + 1))
        args = dict(specs=lambda: None)
        call = lambda: loop(mpit_tpu.init(), state, step_fn, _batches(), steps=20,  # noqa: E731
                            logger=log, ckpt=ck, **args, **kw)
    else:
        state = TrainState(step=0, params={}, opt_state=None)

        def bump(s):
            s.step += 1
            return s

        step_fn = _scripted(nan_at, term_at, torch.tensor, bump)
        call = lambda: loop(state, step_fn, _batches(), steps=20, device="cpu",  # noqa: E731
                            logger=log, ckpt=ck, **kw)
    try:
        out = call()
        result = (int(out["steps"]), out["restores"], out["preempted"],
                  [repr(x) for x in out["losses"]])
    except (Diverged, JDiverged) as e:
        result = ("raised", e.step, e.detected_step, str(e))
    return result, ck.calls, log.records


@pytest.mark.parametrize("case", sorted(_LOOP_CASES))
def test_loop_bookkeeping_equals_jax(case):
    kw, nan_at, term_at = _LOOP_CASES[case]
    want = _drive(j_hardened_loop, kw, nan_at, term_at, jax_side=True)
    got = _drive(hardened_loop, kw, nan_at, term_at, jax_side=False)
    assert got == want
    events = [json.loads(m).get("event") for _, m in got[2]]
    if case == "lag1_backoff":  # the second restore backs off below the first target
        assert [c for c in got[1] if c[0] == "restore"] == [("restore", 6), ("restore", 3)]
        assert events.count("restored_after_divergence") == got[0][1] == 2
    if case in ("sync_raise", "no_candidate"):
        assert got[0][0] == "raised"
    if case == "preempt":
        assert "preempted_checkpoint_and_exit" in events and got[0][2] is True
    if case == "final_save":
        assert got[1][-2:] == [("save", 20, 20), ("wait",)]


# ---- resume equals the uninterrupted run -----------------------------------------


def _lenet_ranks(p, seed=0):
    """p LeNets from one seeded init, their loss functions and state."""
    init = LeNet(generator=torch.Generator().manual_seed(seed)).state_dict()
    models = [LeNet() for _ in range(p)]
    for m in models:
        m.load_state_dict(init)
    fns = [runner._classifier_fns(m, top5=False)[0] for m in models]
    return models, fns


def _lenet_run(p, mode, batches, *, ckpt=None, steps, state=None, **kw):
    world = None if p == 1 else comm.init({"data": p}, devices=["cpu"])
    models, fns = _lenet_ranks(p, seed=0 if state is None else 1)
    init_fn, step_fn = make_train_step(fns[0] if p == 1 else fns, goo(0.05, 0.9), world,
                                       grad_sync=mode)
    named = [dict(m.named_parameters()) for m in models]
    st = init_fn(named[0] if p == 1 else named)
    if ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(st)
        assert st.replicas_equal()
    out = hardened_loop(st, step_fn, iter(batches[st.step:]), steps=steps, device="cpu",
                        log_every=1, ckpt=ckpt, world=world, **kw)
    return out


@pytest.mark.parametrize("p,mode", [(1, "psum"), (4, "psum"), (4, "ring")])
def test_resume_equals_uninterrupted_bitwise(tmp_path, p, mode):
    stream = synthetic_mnist(seed=0).batches(32)
    batches = [next(stream) for _ in range(8)]
    full = _lenet_run(p, mode, batches, steps=8)
    ck = CheckpointManager(tmp_path)
    first = _lenet_run(p, mode, batches, ckpt=ck, steps=4, ckpt_every=2)
    assert ck.all_steps() == [2, 4]
    # A fresh state from another init: the restore overwrites it in place.
    rest = _lenet_run(p, mode, batches, ckpt=ck, steps=8, ckpt_every=2, state="fresh")
    assert first["losses"] + rest["losses"] == full["losses"]
    a, b = full["state"], rest["state"]
    if p == 1:
        for n, t in a.params.items():
            assert torch.equal(t, b.params[n]), n
        bufs = zip(a.opt_state.momentum.values(), b.opt_state.momentum.values())
    else:
        assert torch.equal(a.flat.params, b.flat.params) and b.replicas_equal()
        bufs = zip(a.opt_state.momentum, b.opt_state.momentum)
    assert all(torch.equal(x, y) for x, y in bufs)


def test_resnet_resume_carries_the_batchnorm_buffers(tmp_path, monkeypatch):
    """``resnet --ckpt-dir`` over two ranks (the model cut to two stages,
    as ``tests/test_torch_resnet.py``'s CLI tests cut it): the resumed
    run's losses and its eval through the running statistics (the
    state's ``extra``) equal the uninterrupted run's bit for bit."""
    from mpit_tpu_torch.models import ResNet50

    monkeypatch.setattr(resnet, "ResNet50",
                        lambda *a, **kw: ResNet50(*a, stage_sizes=(1, 1), **kw))
    args = ["--image-size", "32", "--num-classes", "10", "--batch-size", "8", "--eval-batch",
            "8", "--log-every", "1", "--mesh", "data=2", *CPU]
    full = resnet.main(["--steps", "4", *args])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = resnet.main(["--steps", "2", *ck, *args])
    rest = resnet.main(["--steps", "4", *ck, *args])
    assert first["losses"] + rest["losses"] == full["losses"]
    assert rest["eval"] == full["eval"] and rest["replicas_identical"]


def test_sigterm_checkpoints_then_resumes(tmp_path):
    """SIGTERM from the main thread's own step hook (a forward hook on
    the model): the step in flight finishes, the run saves and exits
    resumable, the dense file is written too, and the resumed run equals
    the one never stopped."""
    full = mnist.main(["--steps", "8", *MNIST])
    calls = {"n": 0}

    def hook(module, args):
        if isinstance(module, LeNet):
            calls["n"] += 1
            if calls["n"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    ck = str(tmp_path / "ck")
    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        cut = mnist.main(["--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "5",
                          "--save-dense", str(tmp_path / "d.npz"), *MNIST])
    finally:
        handle.remove()
    assert cut["preempted"] and cut["steps"] == 3
    assert CheckpointManager(ck).all_steps() == [3]
    assert load_dense(str(tmp_path / "d.npz")).step == 3
    rest = mnist.main(["--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "5", *MNIST])
    assert not rest["preempted"] and rest["steps"] == 8
    assert cut["losses"] + rest["losses"] == full["losses"]
    assert rest["eval"] == full["eval"]
    assert CheckpointManager(ck).all_steps() == [3, 5]


def test_cli_divergence_restore_and_max_restores(tmp_path):
    """A loss made non-finite once (a forward hook poisons one batch):
    the run restores the newest checkpoint and completes; poisoned
    twice with --max-restores 1, it raises."""
    def poison(at):
        calls = {"n": 0}

        def hook(module, args):
            if isinstance(module, LeNet):
                calls["n"] += 1
                if calls["n"] in at:
                    return (args[0] * float("nan"),)
            return None

        return torch.nn.modules.module.register_module_forward_pre_hook(hook)

    args = ["--steps", "10", "--ckpt-every", "2", "--fetch-lag", "0", *MNIST]
    handle = poison({6})
    try:
        out = mnist.main(["--ckpt-dir", str(tmp_path / "a"), *args])
    finally:
        handle.remove()
    assert out["restores"] == 1 and out["steps"] == 10
    assert all(math.isfinite(x) for x in out["losses"])
    handle = poison({6, 9})
    try:
        with pytest.raises(Diverged):
            mnist.main(["--ckpt-dir", str(tmp_path / "b"), *args])
    finally:
        handle.remove()


# ---- the dense cross-geometry format -------------------------------------------------

JCFG = JConfig.tiny(dtype=jnp.float32, max_seq_len=16, num_layers=2, num_heads=2, d_model=64)
TCFG = GPT2Config.tiny(dtype=torch.float32, max_seq_len=16, num_layers=2, num_heads=2,
                       d_model=64)
LR_PEAK, WARM = 1e-3, 2


@pytest.fixture(scope="module")
def jax_dense(tmp_path_factory):
    """JAX's tiny GPT-2 (goo_adam, a warmup schedule) over a 2-device
    sub-mesh after two steps, its DenseState and its .npz; then two more
    steps from a port-written .npz (set by the test) are run by
    ``continue_from``."""
    jworld = mpit_tpu.init({"data": 2}, devices=jax.devices()[:2], set_default=False)
    jmodel = JGPT2(JCFG)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]
    tx = jgoo.goo_adam(jschedules.warmup_constant(LR_PEAK, WARM))

    def loss_fn(p, b):
        return JGPT2.fused_loss_fn(jmodel, p, b["tokens"]), {}

    _, step_fn, _ = j_make_train_step(loss_fn, tx, jworld, donate=False)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, JCFG.vocab_size, (8, 17)).astype(np.int32) for _ in range(4)]
    init_fn, _, _ = j_make_train_step(loss_fn, tx, jworld, donate=False)
    state = init_fn(params)
    for tok in batches[:2]:
        state, _ = step_fn(state, j_shard_batch(jworld, {"tokens": tok}))
    path = str(tmp_path_factory.mktemp("dense") / "jax.npz")
    j_save_dense(path, j_dense_from_dp(state), num_heads=2, tie_head=True)

    def continue_from(npz):
        st = j_dp_from_dense(j_load_dense(npz), tx, jworld)
        losses = []
        for tok in batches[2:]:
            st, m = step_fn(st, j_shard_batch(jworld, {"tokens": tok}))
            losses.append(float(m["loss"]))
        return losses

    return {"state": state, "path": path, "batches": batches, "continue": continue_from}


def _port_gpt2(p, tx=None):
    world = None if p == 1 else comm.init({"data": p}, devices=["cpu"])
    models = [GPT2(TCFG, generator=torch.Generator().manual_seed(5)) for _ in range(p)]
    fns = [(lambda m: lambda prm, b: (GPT2.fused_loss_fn(m, b["tokens"].long()), {}))(m)
           for m in models]
    tx = goo_adam(schedules.warmup_constant(LR_PEAK, WARM)) if tx is None else tx
    init_fn, step_fn = make_train_step(fns[0] if p == 1 else fns, tx, world)
    named = [dict(m.named_parameters()) for m in models]
    return world, init_fn(named[0] if p == 1 else named), step_fn, tx


def test_dense_npz_equals_jax_key_for_key(jax_dense, tmp_path):
    jstate = jax.tree.map(np.asarray, jax_dense["state"])
    tworld = comm.init({"data": 2}, devices=["cpu"])
    tstate = train_state_from_jax(jstate.params, jstate.opt_state, jstate.step, world=tworld)
    tstate = tstate.bind([GPT2(TCFG) for _ in range(2)])
    tx = goo_adam(schedules.warmup_constant(LR_PEAK, WARM))
    path = save_dense(str(tmp_path / "port.npz"), dense_from_dp(tstate, tx),
                      num_heads=2, tie_head=True)
    with np.load(jax_dense["path"]) as zj, np.load(path) as zt:
        assert zt.files == zj.files  # the same keys in the same order
        assert [k.split("/")[0] for k in zj.files][-4:] == ["s", "s", "meta", "meta"]
        for k in zj.files:
            a, b = zj[k], zt[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    # Each package reads the other's file.
    assert load_dense(jax_dense["path"]).step == j_load_dense(path).step == 2


def test_dense_resumes_across_packages_and_geometry(jax_dense, tmp_path):
    """JAX's file resumed by the port at p 4; the port's file (written
    at p 4) resumed by JAX at p 2; both continuations agree."""
    world, state, step_fn, tx = _port_gpt2(4)
    dp_from_dense(load_dense(jax_dense["path"]), state, tx)
    assert state.step == 2 and state.opt_state.count == 2 and state.replicas_equal()
    port_losses = []
    for tok in jax_dense["batches"][2:]:
        state, m = step_fn(state, shard_batch(world, {"tokens": tok}))
        port_losses.append(m["loss"].item())
    # Back to JAX through a port-written file of the restored state's
    # twin (written before its steps: re-read the JAX file into p 4).
    _, twin, _, _ = _port_gpt2(4)
    dp_from_dense(load_dense(jax_dense["path"]), twin, tx)
    path = save_dense(str(tmp_path / "p4.npz"), dense_from_dp(twin, tx), num_heads=2,
                      tie_head=True)
    jax_losses = jax_dense["continue"](path)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0, atol=1e-5)
    assert jax_dense["continue"](jax_dense["path"]) == jax_losses  # bit-equal files


def test_dense_rescale_p4_to_p2(tmp_path):
    """tests/test_convert.py's rescale at p 4 → 2, goo SGD with momentum
    (lr 0.05, 0.9) as there: sync DP is mesh-size invariant given the
    same global batches, within that test's pin."""
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, TCFG.vocab_size, (8, 17)).astype(np.int32) for _ in range(6)]
    w4, s4, step4, tx = _port_gpt2(4, goo(0.05, 0.9))
    for tok in toks[:3]:
        s4, _ = step4(s4, shard_batch(w4, {"tokens": tok}))
    path = save_dense(str(tmp_path / "r.npz"), dense_from_dp(s4, tx))
    w2, s2, step2, _ = _port_gpt2(2, tx)
    dp_from_dense(load_dense(path), s2, tx)
    assert s2.step == 3 and s2.opt_state.momentum[0].shape[0] == 2  # shards re-cut
    for tok in toks[3:]:
        s4, _ = step4(s4, shard_batch(w4, {"tokens": tok}))
        s2, _ = step2(s2, shard_batch(w2, {"tokens": tok}))
    assert s2.replicas_equal()
    for n, t in s4.params[0].items():
        np.testing.assert_allclose(s2.params[0][n].detach().numpy(), t.detach().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=n)


def test_dense_lenet_conv_layouts_both_ways(tmp_path):
    """LeNet under goo momentum (no scalar leaf at a constant lr): a
    ZeRO-1 state of JAX's layout over 2 devices (JAX's LeNet tree, its
    values and its momentum's flat vector random) and the port's state
    it is written into give the same file; the port's parameters are the JAX tree's, conv kernels HWIO →
    OIHW."""
    jsharded = importlib.import_module("mpit_tpu.opt.sharded")
    shapes = jax.eval_shape(JLeNet().init, jax.random.key(1), jnp.zeros((1, 28, 28, 1)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                          shapes["params"])
    n = jsharded.padded_len(jsharded.flat_len(params), 2)
    mom = rng.standard_normal(n).astype(np.float32)
    jstate = JTrainState(step=jnp.asarray(5, jnp.int32), params=params,
                         opt_state=jgoo.GooState(momentum=mom, count=()), extra=())
    jpath = j_save_dense(str(tmp_path / "j.npz"), j_dense_from_dp(jstate))
    tworld = comm.init({"data": 2}, devices=["cpu"])
    models = [LeNet() for _ in range(2)]
    tx = goo(0.05, 0.9)
    init_fn, _ = make_train_step([runner._classifier_fns(m, False)[0] for m in models], tx,
                                 tworld)
    tstate = init_fn([dict(m.named_parameters()) for m in models])
    dp_from_dense(load_dense(jpath), tstate, tx)
    assert tstate.step == 5 and tstate.replicas_equal()
    want = conv_params_from_jax(params, models[0])
    for n_, t in tstate.params[1].items():
        assert torch.equal(t.detach(), want[n_]), n_
    tpath = save_dense(str(tmp_path / "t.npz"), dense_from_dp(tstate, tx))
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert zt.files == zj.files and not [k for k in zj.files if k.startswith("s/")]
        assert all(zj[k].tobytes() == zt[k].tobytes() for k in zj.files)


def test_restore_source_resolution(tmp_path, capsys):
    """tests/test_guard.py's sequence: the dense file wins until the
    checkpoint is past its step; the choice is printed."""
    dense, ck = str(tmp_path / "d.npz"), str(tmp_path / "ck")
    common = ["--batch-size", "32", "--lr", "0.02", "--log-every", "3", "--ckpt-dir", ck,
              "--ckpt-every", "3", *CPU]
    mnist.main(["--steps", "6", "--save-dense", dense] + common)
    assert os.path.exists(dense)
    capsys.readouterr()
    out = mnist.main(["--steps", "9", "--resume-dense", dense] + common)
    assert out["steps"] == 9
    assert f"restore source: dense {dense} (step 6)" in capsys.readouterr().out
    out2 = mnist.main(["--steps", "12", "--resume-dense", dense] + common)
    assert out2["steps"] == 12
    assert "(step 9 > dense step 6)" in capsys.readouterr().out


def test_trained_gpt2_serves_from_its_dense_file(tmp_path):
    """A port-trained GPT-2's --save-dense file: the final save of the
    checkpoint cadence lands, the file loads in the port's serve path
    and in JAX's ``load_gpt2_params``, and greedy tokens served from it
    equal those of an engine built from the trained parameters in
    memory (the rank 0 model, caught by a forward hook)."""
    from mpit_tpu.serve.weights import load_gpt2_params as j_load_gpt2_params
    from mpit_tpu_torch.serve import Engine, Request, Server
    from mpit_tpu_torch.serve.__main__ import main as serve_main
    from mpit_tpu_torch.serve.weights import load_gpt2_params

    args = ["--device", "cpu", "--vocab-size", "128", "--seq-len", "32", "--num-layers", "2",
            "--num-heads", "2", "--d-model", "64", "--batch-size", "8", "--steps", "3",
            "--log-every", "1"]
    path = str(tmp_path / "g.npz")
    seen = []
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: seen.append(m) if isinstance(m, GPT2) and not seen else None)
    try:
        out = gpt2.main([*args, "--mesh", "data=2", "--save-dense", path, "--ckpt-dir",
                         str(tmp_path / "ck"), "--ckpt-every", "2"])
    finally:
        handle.remove()
    assert out["steps"] == 3
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2, 3]  # cadence + final save
    state, cfg = load_gpt2_params(path)
    assert (cfg.num_heads, cfg.tie_head, cfg.num_layers) == (2, True, 2)
    assert j_load_gpt2_params(path)[1].num_heads == 2

    def tokens(params):
        server = Server(Engine(cfg, params, device="cpu", slots=2, max_len=24, prefill_len=8))
        for i, prompt in enumerate(([1, 2, 3], [5, 9], [7] * 6)):
            server.submit(Request(rid=i, prompt=prompt, max_new_tokens=6))
        return {c.rid: c.tokens for c in server.run()}

    memory = {n: t.detach().clone() for n, t in seen[0].state_dict().items()}
    assert tokens(state) == tokens(memory)
    served = serve_main(["--device", "cpu", "--ckpt", path, "--requests", "2",
                         "--max-new-tokens", "3", "--max-len", "24", "--prefill-len", "8"])
    assert served["requests_completed"] == 2 and served["model"]["source"] == path
