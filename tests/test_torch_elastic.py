"""mpit_tpu_torch's elastic EASGD tier against mpit_tpu's, on the CPU.

- ``anchor_server`` with replicas sequenced by the test (a fixed
  arrival order of registers, exchanges, a quarantine, a rejoin and the
  stops), under both packages: the same centre bit for bit (the same f32
  arithmetic: ``x̃ + α·(x − x̃)``, α rounded to f32), the same version,
  events and ``alpha_final``, and every reply's pulled parameters bit
  for bit;
- one replica (a fixed arrival order) of ``mnist --mode elastic`` from
  JAX's LeNet init: the logged losses and the centre's eval loss within
  1e-4 relative (XLA and PyTorch sum the convolutions in other orders,
  carried through 12 steps and three exchanges), the same anchor version
  and events; three ranks learn;
- the fault paths on the toy problem of ``tests/test_elastic.py`` (8
  dims, one quadratic), under the same ``FaultPlan`` in both packages:
  kill and rejoin from the checkpoint, NaN quarantine with the centre
  finite, a hang past the lease (evict, then readmit), a dead anchor
  (``AnchorTimeoutError``): the same event kinds for the faulted
  replica, every registration and stop, and the same replica statistics
  (the leases are wall-clock, so ages, the order of concurrent events
  and a loaded host's starved heartbeats are not compared); in both
  packages the anchor notes each eviction and staleness breach into the
  run's sentinel;
- the refusals.

Every compat job carries its own time limit.
"""

from __future__ import annotations

import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu import compat as jcompat
from mpit_tpu.asyncsgd import mnist as jmnist
from mpit_tpu.models import LeNet as JLeNet
from mpit_tpu.obs import Sentinel as JSentinel
from mpit_tpu.train import TrainState as JTrainState
from mpit_tpu.train import elastic as jelastic
from mpit_tpu_torch import compat as tcompat
from mpit_tpu_torch.asyncsgd import mnist
from mpit_tpu_torch.asyncsgd.__main__ import main as cli_main
from mpit_tpu_torch.compat import FaultPlan, MessageRule
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.models.layers import params_from_jax
from mpit_tpu_torch.obs import Sentinel
from mpit_tpu_torch.train import AnchorTimeoutError, TrainState
from mpit_tpu_torch.train import elastic as telastic

JOB_TIMEOUT = 60.0
DIM = 8
TARGET = np.linspace(-1.0, 1.0, DIM).astype(np.float32)


# ---- the anchor server for a fixed arrival order ---------------------------------

# (rank, action, payload seed); the stamps make replica 2's last pull stale.
_SCRIPT = [
    (1, "register", None), (2, "register", None), (1, "exchange", 1), (2, "exchange", 2),
    (1, "exchange", 3), (1, "exchange", 4), (1, "quarantine", None), (2, "exchange", 5),
    (1, "rejoin", None), (1, "exchange", 6), (2, "stop", None), (1, "stop", None),
]


def _anchor_run(pkg: str) -> dict:
    compat = jcompat if pkg == "jax" else tcompat
    el = jelastic if pkg == "jax" else telastic
    cfg = el.ElasticConfig(replicas=2, beta=0.5, staleness_bound=1, lease_s=30.0,
                           heartbeat_s=1.0)
    init = np.random.default_rng(0).standard_normal(DIM).astype(np.float32)
    turns = [threading.Event() for _ in range(len(_SCRIPT) + 1)]
    turns[0].set()
    pulled: list = []

    def as_np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def replica(rank: int):
        client = el.AnchorClient(DIM, cfg)
        for i, (r, action, seed) in enumerate(_SCRIPT):
            if r != rank:
                continue
            assert turns[i].wait(JOB_TIMEOUT)
            if action == "register":
                pulled.append((i, as_np(client.register(0)).copy()))
            elif action == "rejoin":
                pulled.append((i, as_np(client.rejoin(3)).copy()))
            elif action == "exchange":
                x = np.random.default_rng(seed).standard_normal(DIM).astype(np.float32)
                x = x if pkg == "jax" else torch.from_numpy(x)
                pulled.append((i, as_np(client.exchange(x, i)).copy(), client.version,
                               client.alpha))
            elif action == "quarantine":
                client.quarantine(i)
            else:
                client.stop(i)
            turns[i + 1].set()

    def main(rank: int):
        if rank == 0:
            init_flat = init if pkg == "jax" else torch.from_numpy(init)
            return el.anchor_server(init_flat, cfg)
        return replica(rank)

    server = compat.run(main, 3, pass_rank=True, timeout=JOB_TIMEOUT)[0]
    return {"center": as_np(server["center"]).tobytes(), "version": server["version"],
            "events": server["events"], "alpha_final": server["alpha_final"],
            "counts": (server["evictions"], server["rejoins"], server["quarantines"]),
            "pulled": [(p[0], p[1].tobytes(), *p[2:]) for p in sorted(pulled, key=lambda p: p[0])]}


def test_anchor_server_equals_jax_for_a_fixed_order():
    want, got = _anchor_run("jax"), _anchor_run("torch")
    assert got == want
    kinds = [e[0] for e in got["events"]]
    assert kinds.count("staleness_exceeded") >= 1
    assert ("quarantined", 1, 6) in got["events"] and ("rejoined", 1, "rejoin") in got["events"]
    assert got["version"] == 6


def test_anchor_refuses_sentinel_and_unknown_tags():
    # The anchor takes a sentinel now (the evictions it notes: the fault
    # paths below); an unknown tag still fails the job with one wired.
    sentinel = Sentinel()

    def main(rank: int):
        if rank == 0:
            return telastic.anchor_server(torch.zeros(2), telastic.ElasticConfig(replicas=1),
                                          sentinel=sentinel)
        ship = tcompat.Comm_dup(None, key=telastic.ANCHOR_CHANNEL)
        tcompat.Send(torch.zeros(2), dest=0, tag=99, comm=ship)
        return None

    with pytest.raises(RuntimeError, match="unexpected tag 99"):
        tcompat.run(main, 2, pass_rank=True, timeout=JOB_TIMEOUT)


# ---- mnist --mode elastic --------------------------------------------------------

ELASTIC = ["--mode", "elastic", "--steps", "12", "--batch-size", "16", "--log-every", "2",
           "--sync-every", "4", "--easgd-beta", "0.5", "--heartbeat-s", "0.05",
           "--lease-s", "5", "--eval-batch", "64"]


def test_one_replica_mnist_elastic_equals_jax():
    want = jmnist.main(ELASTIC + ["--nranks", "2"])
    params = JLeNet().init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    got = mnist.main(ELASTIC + ["--nranks", "2", "--device", "cpu", "--ps-timeout", "60"],
                     initial_params=params_from_jax(jax.tree.map(np.asarray, params), LeNet()))
    assert got["mode"] == want["mode"] == "elastic"
    assert got["anchor_version"] == want["anchor_version"] == 3
    assert got["server"]["events"] == want["server"]["events"]
    assert len(got["losses"]) == len(want["losses"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=1e-4)
    assert set(got) == set(want) | {"device"}
    stats, jstats = got["replica_stats"][0], want["replica_stats"][0]
    for key in ("exchanges", "steps", "completed", "restores", "quarantines", "crashes"):
        assert stats[key] == jstats[key], key


def test_three_rank_elastic_cli_learns():
    out = mnist.main(["--mode", "elastic", "--nranks", "3", "--steps", "60", "--batch-size",
                      "32", "--sync-every", "4", "--easgd-beta", "0.5", "--heartbeat-s", "0.05",
                      "--lease-s", "5", "--log-every", "10", "--device", "cpu",
                      "--ps-timeout", "60"])
    assert out["replicas"] == 2 and out["steps_per_replica"] == 30
    assert out["anchor_version"] == 2 * (30 // 4)
    assert not out["server"]["evictions"]
    assert out["final_loss"] < out["losses"][0]
    assert out["eval"]["accuracy"] > 0.3
    assert out["flight"]["step_straggler_rank"] in (1, 2)


# ---- the fault paths, both packages under the same FaultPlan ----------------------


def _jax_toy():
    def init_state():
        return JTrainState(step=jnp.zeros((), jnp.int32), params=jnp.zeros((DIM,), jnp.float32),
                           opt_state=(), extra=())

    @jax.jit
    def step(state, batch):
        loss, g = jax.value_and_grad(lambda p: jnp.sum((p - batch["t"]) ** 2))(state.params)
        return state._replace(step=state.step + 1, params=state.params - 0.05 * g), {"loss": loss}

    return init_state, step


def _torch_toy():
    state = TrainState(step=0, params=torch.zeros(DIM), opt_state=())

    def step(state, batch):
        p = state.params
        with torch.enable_grad():
            p.requires_grad_(True)
            loss = ((p - batch["t"]) ** 2).sum()
            (g,) = torch.autograd.grad(loss, [p])
            p.requires_grad_(False)
        with torch.no_grad():
            p.sub_(0.05 * g)
        state.step += 1
        return state, {"loss": loss.detach()}

    return state, step


def _streams(ridx, skip):
    del ridx, skip

    def gen():
        while True:
            yield {"t": TARGET}

    return gen()


def _fleet(pkg: str, plan_kw: dict, cfg_kw: dict, ckpt: bool):
    base = dict(replicas=2, steps=24, sync_every=3, log_every=6, heartbeat_s=0.02,
                lease_s=0.3, beta=0.5)
    base.update(cfg_kw)
    with tempfile.TemporaryDirectory() as d:
        if ckpt:
            base["ckpt_dir"] = d
        if pkg == "jax":
            import mpit_tpu
            from mpit_tpu.compat import FaultPlan as JFaultPlan
            from mpit_tpu.compat import MessageRule as JMessageRule

            rules = [JMessageRule(**r) for r in plan_kw.pop("rules", [])]
            plan = JFaultPlan(message_rules=rules, **plan_kw)
            init_state, step = _jax_toy()
            cfg = jelastic.ElasticConfig(**base)
            return jelastic.run_elastic(mpit_tpu.init(), cfg, init_state, step, _streams,
                                        fault_plan=plan, sentinel=JSentinel(),
                                        job_timeout_s=JOB_TIMEOUT)
        rules = [MessageRule(**r) for r in plan_kw.pop("rules", [])]
        plan = FaultPlan(message_rules=rules, **plan_kw)
        cfg = telastic.ElasticConfig(**base)
        return telastic.run_elastic(cfg, _torch_toy, _streams, fault_plan=plan,
                                    sentinel=Sentinel(), job_timeout_s=JOB_TIMEOUT)


_FAULTS = {  # id: (FaultPlan keywords, ElasticConfig keywords, checkpoints, faulted rank)
    "kill_rejoin": (dict(kill_at={1: 14}, rejoin_delay_s=0.9),
                    dict(steps=30, lease_s=0.3, ckpt_every=5), True, 1),
    "nan_quarantine": (dict(nan_at={2: 9}),
                       dict(steps=30, lease_s=1.5, max_restores=2, ckpt_every=5, log_every=5),
                       True, 2),
    "hang_readmit": (dict(hang_at={1: (10, 0.9)}), dict(steps=30, lease_s=0.3), False, 1),
}
_STATS = ("crashes", "rejoins", "restores", "quarantines", "completed", "steps",
          "rejoin_steps_to_recover", "dead_at")


def _kinds(out, rank: int) -> list:
    """The server's events as sorted (kind, rank) pairs, the faulted
    rank's and every registration and stop, readmissions by rejoin with
    how, minus what wall-clock timing decides (eviction ages, the order
    of concurrent events, staleness notes; a loaded host may also starve
    a healthy replica's heartbeats past a lease)."""
    keep = []
    for e in out["server"]["events"]:
        if e[0] == "staleness_exceeded" or (e[1] != rank and e[0] not in ("registered",
                                                                          "stopped")):
            continue
        keep.append((e[0], e[1], e[2]) if e[0] == "rejoined" and e[2] == "rejoin" else e[:2])
    return sorted(keep)


@pytest.mark.parametrize("case", sorted(_FAULTS))
def test_fault_paths_give_jax_event_kinds(case):
    plan_kw, cfg_kw, ckpt, rank = _FAULTS[case]
    want = _fleet("jax", dict(plan_kw), cfg_kw, ckpt)
    got = _fleet("torch", dict(plan_kw), cfg_kw, ckpt)
    assert _kinds(got, rank) == _kinds(want, rank)
    assert got["fault_events"] == want["fault_events"]
    for g, w in zip(got["replicas"], want["replicas"]):
        assert {k: g.get(k) for k in _STATS} == {k: w.get(k) for k in _STATS}
    assert bool(torch.isfinite(got["center"]).all())
    assert float((got["center"] - torch.from_numpy(TARGET)).abs().max()) < 0.5
    if case == "hang_readmit":
        rejoined = [e for e in got["server"]["events"] if e[0] == "rejoined"]
        assert rejoined and rejoined[0][2] in ("heartbeat", "exchange")
        assert 1 in [e[1] for e in got["server"]["events"] if e[0] == "evicted"]
    for out in (got, want):  # every eviction and staleness breach noted
        counts = out["sentinel"]["anomaly_counts"]
        for kind in ("evicted", "staleness_exceeded"):
            assert counts.get(kind, 0) == sum(e[0] == kind for e in out["server"]["events"])
    if case == "hang_readmit":
        assert not got["sentinel"]["clean"]


def test_dead_anchor_is_a_structured_failure():
    drop = {"rules": [dict(kind="drop", src=1, dst=0, tag=telastic.TAG_EXCH)]}
    kw = dict(steps=12, sync_every=2, exchange_timeout_s=0.1, exchange_retries=1)
    with pytest.raises(jelastic.AnchorTimeoutError):
        _fleet("jax", dict(drop, rules=list(drop["rules"])), kw, False)
    with pytest.raises(AnchorTimeoutError, match="anchor exchange on rank 1"):
        _fleet("torch", dict(drop, rules=list(drop["rules"])), kw, False)


# ---- the refusals ---------------------------------------------------------------

_SMALL_IMAGES = ["--image-size", "32", "--num-classes", "10"]


@pytest.mark.parametrize("argv,match", [
    (["imagenet", "--mode", "elastic", *_SMALL_IMAGES], "elastic tier trains mnist only"),
    (["resnet", "--mode", "elastic", *_SMALL_IMAGES], "elastic tier trains mnist only"),
    (["gpt2", "--mode", "elastic", "--device", "cpu"], "elastic tier trains mnist only"),
    # EASGD under SPMD trains now (tests/test_torch_easgd.py); JAX's gpt2
    # ignores --easgd, and the port refuses it there.
    (["gpt2", "--easgd", "true", "--device", "cpu"], "ignores --easgd"),
    (["resnet", "--save-dense", "x.npz", *_SMALL_IMAGES], "ZeRO-1 DP layout"),
    (["mnist", "--save-dense", "x.npz", "--zero1", "false"], "ZeRO-1 DP layout"),
    (["mnist", "--mode", "elastic", "--profile-dir", "/p"], "profile window is the SPMD"),
    (["mnist", "--native", "true"], "data-pipeline slice"),
], ids=["imagenet_elastic", "resnet_elastic", "gpt2_elastic", "easgd_spmd",
        "resnet_save_dense", "zero1_false_save_dense", "sentinel", "native"])
def test_refusals(argv, match):
    if argv[0] != "gpt2":
        argv = [*argv, "--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        cli_main(argv)
