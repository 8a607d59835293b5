"""mpit_tpu_torch's convnet workloads, its parameter-server actors and
its launcher against mpit_tpu's, on the CPU.

The learning checks are those ``tests/test_asyncsgd.py`` asks of JAX's
``mnist.main`` (SPMD, parity Downpour with 1 server + 1 client, parity
EASGD with 3 ranks). With one client the arrival order is fixed, so the
port's parity runs are held to JAX's from the same initial weights
(JAX's ``model.init`` carried across by ``params_from_jax``) on the
same synthetic batches: per-step losses within 1e-5 relative and the
final model's eval loss within 1e-5 relative (XLA and PyTorch sum the
convolutions in other orders; the eval loss is read on the server's
final parameters). The actors alone, fed the same gradients and
parameters from numpy: every reply and the final server parameters
within 1e-6 relative (the same f32 arithmetic, fused differently), held
to 1e-4. Every compat job carries its own time limit.
"""

from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.asyncsgd import actors as jactors
from mpit_tpu.asyncsgd import mnist as jmnist
from mpit_tpu.models import LeNet as JLeNet
from mpit_tpu_torch.asyncsgd import actors, imagenet, mnist
from mpit_tpu_torch.asyncsgd.__main__ import main as cli_main
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.models.layers import params_from_jax

jgoo = importlib.import_module("mpit_tpu.opt.goo")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")

CPU = ["--device", "cpu", "--ps-timeout", "60"]


# ---- the workloads learn (tests/test_asyncsgd.py's checks) ---------------------


def test_mnist_spmd_learns():
    out = mnist.main(["--steps", "30", "--batch-size", "32", "--log-every", "10", *CPU])
    assert out["mode"] == "spmd" and out["steps"] == 30 and out["ranks"] == 1
    assert out["final_loss"] < 0.5 < out["losses"][0]
    assert out["eval"]["top1"] > 0.7 and "top5" not in out["eval"]


def test_mnist_parity_downpour_1server_1client():
    out = mnist.main(["--mode", "parity", "--nranks", "2", "--steps", "40",
                      "--batch-size", "32", *CPU])
    assert out["protocol"] == "downpour" and out["nranks"] == 2
    assert out["final_loss"] < out["first_loss"]
    assert out["eval"]["accuracy"] > 0.5


def test_mnist_parity_easgd_multiclient():
    out = mnist.main(["--mode", "parity", "--nranks", "3", "--steps", "60",
                      "--batch-size", "32", "--easgd", "true", "--sync-every", "4", *CPU])
    assert out["protocol"] == "easgd" and len(out["losses"]) == 30
    assert out["final_loss"] < 1.0
    assert out["eval"]["accuracy"] > 0.5


# ---- one client: the port's parity runs against JAX's ----------------------------

_PARITY = {  # id: extra flags
    "downpour": [],
    "easgd": ["--easgd", "true", "--sync-every", "2"],
}


@pytest.fixture(scope="module")
def lenet_init():
    params = JLeNet().init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("protocol", sorted(_PARITY))
def test_one_client_parity_run_matches_jax(lenet_init, protocol):
    args = ["--mode", "parity", "--nranks", "2", "--steps", "6", "--batch-size", "16",
            "--eval-batch", "64", *_PARITY[protocol]]
    want = jmnist.main(args)
    got = mnist.main([*args, *CPU], initial_params=params_from_jax(lenet_init, LeNet()))
    assert got["protocol"] == want["protocol"] == protocol
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    assert got["first_loss"] == got["losses"][0] and got["final_loss"] == got["losses"][-1]
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=1e-5)
    assert got["eval"]["accuracy"] == want["eval"]["accuracy"]


@pytest.mark.parametrize("protocol", sorted(_PARITY))
def test_parameter_server_matches_jax(protocol):
    """The actors alone: one client pushes the same gradients (Downpour)
    or exchanges the same parameters (EASGD, alpha 0.25) on both sides."""
    rng = np.random.default_rng(3)
    n, rounds, lr, alpha = 1000, 4, 0.1, 0.25
    flat0 = rng.standard_normal(n).astype(np.float32)
    payloads = [rng.standard_normal(n).astype(np.float32) for _ in range(rounds)]

    def client(fetch, push, exchange, as_np):
        replies = []
        for k, x in enumerate(payloads):
            if protocol == "downpour":
                replies.append(as_np(fetch()).copy())
                push(x)
            else:
                replies.append(as_np(exchange(x + k)).copy())
        return replies

    def jclient(c, widx):
        return client(c.fetch, c.push_grad, lambda x: c.elastic_exchange(x, alpha), np.asarray)

    def tclient(c, widx):
        return client(c.fetch, lambda x: c.push_grad(torch.from_numpy(x)),
                      lambda x: c.elastic_exchange(torch.from_numpy(x), alpha),
                      lambda t: t.numpy())

    want = jactors.run_parameter_server(flat0, jgoo.goo(lr, 0.9), jclient, nranks=2,
                                        easgd_alpha=alpha)
    got = actors.run_parameter_server(torch.from_numpy(flat0), tgoo.goo(lr, 0.9), tclient,
                                      nranks=2, easgd_alpha=alpha, timeout=30)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-4, atol=1e-6)
    assert not np.array_equal(got[0].numpy(), flat0)


# ---- the launcher ------------------------------------------------------------------


def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_runs_the_convnets_on_the_cpu(capsys):
    assert cli_main(["mnist", "--steps", "3", "--batch-size", "16", "--log-every", "1",
                     "--mesh", "data=4", "--grad-sync", "ring_q8", "--eval-batch", "16",
                     *CPU]) == 0
    out = _json_line(capsys)
    for key in ("mode", "world", "steps", "losses", "final_loss", "restores", "preempted",
                "eval"):
        assert key in out, key
    assert out["ranks"] == 4 and out["grad_sync"] == "ring_q8_plain"
    assert out["replicas_identical"] and len(out["losses"]) == 3
    assert cli_main(["imagenet", "--steps", "2", "--batch-size", "4", "--image-size", "64",
                     "--num-classes", "8", "--eval-batch", "4", "--lr", "0.001",
                     "--log-every", "1", *CPU]) == 0
    out = _json_line(capsys)
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert set(out["eval"]) == {"loss", "top1", "top5"}
    assert cli_main(["mnist", "--mode", "parity", "--nranks", "3", "--steps", "4",
                     "--batch-size", "8", "--eval-batch", "8", *CPU]) == 0
    out = _json_line(capsys)
    assert out["protocol"] == "downpour" and len(out["losses"]) == 2
    assert set(out["eval"]) == {"accuracy", "loss"}


def test_val_sweep_every_n_steps():
    out = mnist.main(["--steps", "4", "--batch-size", "8", "--log-every", "2",
                      "--eval-every", "2", "--eval-batch", "8", "--eval-batches", "2", *CPU])
    assert set(out["eval"]) == {"loss", "top1"} and 0.0 <= out["eval"]["top1"] <= 1.0


# The ResNet slice brought ``resnet``, ``--data-dir`` and ``--augment``,
# the checkpoint and elastic slice ``--mode elastic`` and ``--lease-s``,
# the EASGD-under-SPMD slice ``--easgd true``:
# their cases (ids kept) now hold what stays refused around them, each
# with its own reason.
_NOW = {
    "resnet": (["resnet", "--mode", "parity"], "SPMD-only"),
    "mnist_datadir_/d": (["mnist", "--data-dir", "/d", "--native", "true"], "slice"),
    "imagenet_augment_true": (["imagenet", "--augment", "true", "--augment-mode", "rrc"],
                              "need --data-dir"),
    "imagenet_trainsize_128": (["imagenet", "--train-size", "128"], "need --data-dir"),
    "mnist_mode_elastic": (["mnist", "--mode", "elastic", "--sentinel", "true",
                            "--native", "true"], "slice"),
    "imagenet_mode_elastic": (["imagenet", "--mode", "elastic"], "mnist only"),
    "mnist_leases_2": (["mnist", "--mode", "elastic", "--lease-s", "2", "--profile-dir", "/p"],
                       "profile window is the SPMD"),
    "mnist_easgd_true": (["mnist", "--easgd", "true", "--prefetch-workers", "2"], "slice"),
    # The model axis serves, and trains gpt2 (its pjit tier); mnist still
    # trains on the data axis alone.
    "mnist_mesh_data=2,model=2": (["mnist", "--mesh", "data=2,model=2"],
                                  "this workload trains on the data axis"),
}


@pytest.mark.parametrize(
    "argv",
    [
        ["resnet"],
        ["mnist", "--mode", "elastic"],
        ["imagenet", "--mode", "elastic"],
        ["mnist", "--easgd", "true"],
        ["mnist", "--data-dir", "/d"],
        ["imagenet", "--augment", "true"],
        ["imagenet", "--train-size", "128"],
        ["mnist", "--lease-s", "2"],
        ["mnist", "--mesh", "data=2,model=2"],
    ],
    ids=lambda a: "_".join(a).replace("-", ""),
)
def test_later_slices_raise(argv):
    argv, match = _NOW.get("_".join(argv).replace("-", ""), (argv, "slice"))
    with pytest.raises(SystemExit, match=match):
        cli_main([*argv, *CPU])


def test_convnets_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mnist.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imagenet.main(["--steps", "1", "--mode", "parity"])
