"""mpit_tpu_torch's convnet slice (data, models, the converter, the
step and the eval step) against mpit_tpu's, on the CPU.

Inputs are made by numpy from a seed, or by the synthetic streams that
both packages make bit for bit, and handed to both. Tolerances, with
their reasons:

- the synthetic classification streams: bit-equal (the same numpy
  calls on the same seeds);
- LeNet at 28×28 and AlexNet in f32 at 96×96 (its last map 2×2, so a
  wrong flatten order shows; at JAX's test size 64 the map is 1×1),
  from ``params_from_jax``: logits within ``1e-5·max(1, max |logits|)``
  and every gradient leaf within ``1e-4·max(1, max |g|)`` (XLA and
  PyTorch sum the convolutions and products in other orders);
- AlexNet's default bf16 forward: within ``0.01·max(1, max |logits|)``.
  Both sides round every layer's output to bf16 (8 significant bits,
  a relative step of 2^-8 = 0.0039) after summing in other orders, and
  a rounding that falls the other way in an early layer is carried
  through eight layers (observed over init seeds 0-2: at most 0.0030 of
  max |logits|; the bf16 forward parts from the f32 one by 0.0027 to
  0.0049);
- three f32 steps of goo SGD (lr 0.05, momentum 0.9) on LeNet, one rank
  and at p 4 with ``psum`` and ``ring``, against JAX's
  ``make_train_step`` on the fake CPU mesh: losses within 1e-5
  relative. The port's ``ring`` is bit-equal to its ``psum`` at p 2
  (one addition, one order); at p 4 the ring adds the ranks in another
  order than the rank-order sum, so it is held within 1e-6 relative of
  ``psum`` there;
- ``make_eval_step`` at p 2 with a padded ``valid`` mask: ``loss``,
  ``top1``, ``top5`` and ``_weight`` within 1e-6 (continuous logits:
  ``torch.topk`` and ``lax.top_k`` may keep different classes at an
  exact tie).
"""

from __future__ import annotations

import importlib
import inspect

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu
from mpit_tpu.asyncsgd import runner as jrunner
from mpit_tpu.data import shard_batch as j_shard_batch
from mpit_tpu.data import synthetic as jsynth
from mpit_tpu.models import AlexNet as JAlexNet
from mpit_tpu.models import LeNet as JLeNet
from mpit_tpu.train import make_eval_step as j_make_eval_step
from mpit_tpu.train import make_train_step as j_make_train_step
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.data import SyntheticClassification, shard_batch, synthetic_imagenet
from mpit_tpu_torch.data import synthetic_mnist
from mpit_tpu_torch.models import AlexNet, LeNet
from mpit_tpu_torch.models.alexnet import feature_side
from mpit_tpu_torch.models.layers import params_from_jax
from mpit_tpu_torch.opt.sharded import FlatLayout
from mpit_tpu_torch.train import make_eval_step, make_train_step

jgoo = importlib.import_module("mpit_tpu.opt.goo")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")

LR = 0.05
ALEX_SIZE, ALEX_CLASSES = 96, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jparams(jmodel, shape):
    init = jax.jit(jmodel.init)
    return _np(init(jax.random.key(0), jnp.zeros((1, *shape)))["params"])


def _japply(jmodel, params, images):
    return np.asarray(jax.jit(jmodel.apply)({"params": params}, images))


def _jgrad_leaves(jmodel, params, batch):
    """JAX's loss and gradient leaves (flax's tree and layouts)."""
    def loss(p):
        return jrunner.softmax_xent(jmodel.apply({"params": p}, batch["image"]), batch["label"])

    val, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    return float(val), _np(grads)


# ---- data ------------------------------------------------------------------

_STREAMS = {
    "mnist": (lambda m: m.synthetic_mnist(seed=3), 8),
    "imagenet64": (lambda m: m.synthetic_imagenet(image_size=64, num_classes=8, seed=1), 2),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_synthetic_classification_bit_equal_to_jax(name):
    make, bs = _STREAMS[name]
    tds, jds = make(importlib.import_module("mpit_tpu_torch.data.synthetic")), make(jsynth)
    np.testing.assert_array_equal(tds.prototypes, jds.prototypes)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    t, j = tds.batches(bs), jds.batches(bs)
    for _ in range(2):
        same(next(t), next(j))
    same(next(tds.batches(bs, skip=5)), next(jds.batches(bs, skip=5)))
    same(next(tds.batches(bs, seed=107)), next(jds.batches(bs, seed=107)))
    same(tds.eval_batch(bs), jds.eval_batch(bs))
    tv, jv = list(tds.val_batches(bs, num_batches=2)), list(jds.val_batches(bs, num_batches=2))
    assert len(tv) == len(jv) == 2
    for a, b in zip(tv, jv):
        same(a, b)
    assert len(list(tds.val_batches(1))) == 8


def test_synthetic_augment_and_shapes():
    aug = SyntheticClassification(augment=True, crop_pad=2, seed=1)
    plain = SyntheticClassification(seed=1)
    a, b = next(aug.batches(4)), next(plain.batches(4))
    np.testing.assert_array_equal(a["label"], b["label"])
    assert a["image"].shape == b["image"].shape and not np.array_equal(a["image"], b["image"])
    assert synthetic_mnist().image_shape == (28, 28, 1)
    assert synthetic_imagenet(num_classes=2).image_shape == (224, 224, 3)
    assert inspect.signature(synthetic_imagenet).parameters["num_classes"].default == 1000


# ---- models and the converter -----------------------------------------------


@pytest.fixture(scope="module")
def lenet_case():
    jmodel = JLeNet()
    params = _jparams(jmodel, (28, 28, 1))
    batch = synthetic_mnist(seed=0).eval_batch(8)
    logits = _japply(jmodel, params, batch["image"])
    return jmodel, params, batch, logits, _jgrad_leaves(jmodel, params, batch)


@pytest.fixture(scope="module")
def alexnet_case():
    jmodel = JAlexNet(num_classes=ALEX_CLASSES, dtype=jnp.float32)
    params = _jparams(jmodel, (ALEX_SIZE, ALEX_SIZE, 3))
    batch = synthetic_imagenet(image_size=ALEX_SIZE, num_classes=ALEX_CLASSES).eval_batch(4)
    logits = _japply(jmodel, params, batch["image"])
    bf16 = _japply(JAlexNet(num_classes=ALEX_CLASSES), params, batch["image"])
    return jmodel, params, batch, logits, _jgrad_leaves(jmodel, params, batch), bf16


def _check_model(model, params, batch, want_logits, want_grads):
    model.load_state_dict(params_from_jax(params, model))
    x = torch.from_numpy(batch["image"])
    logits = model(x)
    scale = max(1.0, float(np.abs(want_logits).max()))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0, atol=1e-5 * scale)
    loss = runner.softmax_xent(logits, torch.from_numpy(batch["label"]))
    want_loss, jgrads = want_grads
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = params_from_jax(jgrads, model)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=name)


def test_lenet_forward_and_grads_match_flax(lenet_case):
    _, params, batch, logits, grads = lenet_case
    _check_model(LeNet(), params, batch, logits, grads)


def test_alexnet_f32_forward_and_grads_match_flax(alexnet_case):
    _, params, batch, logits, grads, _ = alexnet_case
    assert feature_side(ALEX_SIZE) == 2 and feature_side(224) == 6 and feature_side(64) == 1
    _check_model(AlexNet(ALEX_CLASSES, torch.float32, image_size=ALEX_SIZE), params, batch,
                 logits, grads)


def test_alexnet_bf16_forward_within_bf16_tolerance(alexnet_case):
    _, params, batch, _, _, want = alexnet_case
    model = AlexNet(ALEX_CLASSES, image_size=ALEX_SIZE)
    assert model.dtype == torch.bfloat16
    model.load_state_dict(params_from_jax(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"]))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in model.parameters())
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.01 * scale)


def test_converter_refuses_a_tree_of_another_model(lenet_case):
    _, params, *_ = lenet_case
    wrong = {**params, "Dense_0": {"kernel": np.zeros((4, 120)), "bias": np.zeros(120)}}
    with pytest.raises(ValueError, match="Dense_0"):
        params_from_jax(wrong, LeNet())
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax({k: v for k, v in params.items() if k != "Conv_1"}, LeNet())


def test_flat_layout_follows_ravel_pytree_leaf_order(alexnet_case):
    _, params, *_ = alexnet_case
    model = AlexNet(ALEX_CLASSES, torch.float32, image_size=ALEX_SIZE)
    state = params_from_jax(params, model)
    layout = FlatLayout(state)
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    jnames = [".".join(k.key for k in path) for path, _ in leaves]
    assert layout.names == jnames
    assert set(layout.names) == {n for n, _ in model.named_parameters()}
    assert layout.names[:2] == ["Conv_0.bias", "Conv_0.kernel"]
    assert layout.names[-2:] == ["Dense_2.bias", "Dense_2.kernel"]
    jflat, _ = jax.flatten_util.ravel_pytree(params)
    flat = layout.ravel(state).numpy()
    joff = 0
    for (path, leaf), name in zip(leaves, layout.names):
        n = np.asarray(leaf).size
        seg = flat[layout.offsets[name]: layout.offsets[name] + n]
        jseg = np.asarray(jflat)[joff: joff + n]
        if np.asarray(leaf).ndim == 4:  # OIHW here, HWIO there: the same multiset
            np.testing.assert_array_equal(np.sort(seg), np.sort(jseg))
        else:
            np.testing.assert_array_equal(seg, jseg, err_msg=name)
        joff += n
    assert layout.total == sum(-(-np.asarray(leaf).size // 128) * 128 for _, leaf in leaves)
    alex = FlatLayout(dict(AlexNet(device="meta").named_parameters()))
    assert alex.total == 61_101_056  # 61,100,840 parameters, leaves padded to 128


# ---- three steps of goo SGD ---------------------------------------------------

_STEP_CASES = {  # id: (ranks, grad_sync)
    "one_rank": (1, "psum"),
    "p4_psum": (4, "psum"),
    "p4_ring": (4, "ring"),
}


def _step_batches(n=3, bs=16):
    stream = synthetic_mnist(seed=0).batches(bs)
    return [next(stream) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_step_runs(lenet_case):
    jmodel, params, *_ = lenet_case

    def loss_fn(p, b):
        logits = jmodel.apply({"params": p}, b["image"])
        return jrunner.softmax_xent(logits, b["label"]), {}

    out = {}
    for case, (p, mode) in _STEP_CASES.items():
        world = mpit_tpu.init({"data": p}, devices=jax.devices()[:p], set_default=False)
        init_fn, step_fn, _ = j_make_train_step(
            loss_fn, jgoo.goo(LR, 0.9), world, zero1=True, grad_sync=mode, donate=False
        )
        state = init_fn(jax.tree.map(jnp.asarray, params))
        losses = []
        for b in _step_batches():
            state, m = step_fn(state, j_shard_batch(world, b))
            losses.append(float(m["loss"]))
        out[case] = losses
    return out


def _port_steps(params, p, mode):
    models = [LeNet() for _ in range(p)]
    for m in models:
        m.load_state_dict(params_from_jax(params, m))
    fns = [runner._classifier_fns(m, top5=False)[0] for m in models]
    world = None if p == 1 else comm.init({"data": p}, devices=["cpu"])
    init_fn, step_fn = make_train_step(fns[0] if world is None else fns, tgoo.goo(LR, 0.9),
                                       world, grad_sync=mode)
    named = [dict(m.named_parameters()) for m in models]
    state = init_fn(named[0] if world is None else named)
    losses = []
    for b in _step_batches():
        if world is None:
            b = {k: torch.from_numpy(v) for k, v in b.items()}
        state, m = step_fn(state, b if world is None else shard_batch(world, b))
        losses.append(m["loss"].item())
    return losses, state


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_three_sgd_steps_match_jax(jax_step_runs, lenet_case, case):
    _, params, *_ = lenet_case
    p, mode = _STEP_CASES[case]
    losses, state = _port_steps(params, p, mode)
    np.testing.assert_allclose(losses, jax_step_runs[case], rtol=1e-5, atol=0)
    assert state.replicas_equal()
    assert losses[-1] < losses[0]


def test_ring_against_psum(lenet_case):
    _, params, *_ = lenet_case
    psum2, s_psum = _port_steps(params, 2, "psum")
    ring2, s_ring = _port_steps(params, 2, "ring")
    assert ring2 == psum2
    assert torch.equal(s_psum.flat.params, s_ring.flat.params)
    assert torch.equal(s_psum.opt_state.momentum[0], s_ring.opt_state.momentum[0])
    psum4, _ = _port_steps(params, 4, "psum")
    ring4, _ = _port_steps(params, 4, "ring")
    np.testing.assert_allclose(ring4, psum4, rtol=1e-6, atol=0)


# ---- the eval step -------------------------------------------------------------


def test_eval_step_matches_jax_with_a_padded_batch(lenet_case):
    jmodel, params, *_ = lenet_case
    batch = synthetic_mnist(seed=5).eval_batch(16)
    batch["valid"] = np.asarray([1.0] * 11 + [0.0] * 5, np.float32)  # rank 1: 3 real rows

    def jeval(p, extra, b):
        del extra
        logits = jmodel.apply({"params": p}, b["image"])
        v = b["valid"]
        return {"loss": jrunner.softmax_xent(logits, b["label"], v),
                "top1": jrunner.accuracy(logits, b["label"], v),
                "top5": jrunner.topk_accuracy(logits, b["label"], 5, v),
                "_weight": jnp.sum(v)}

    jworld = mpit_tpu.init({"data": 2}, devices=jax.devices()[:2], set_default=False)
    jstate = mpit_tpu.train.TrainState(step=jnp.zeros((), jnp.int32),
                                       params=jax.tree.map(jnp.asarray, params),
                                       opt_state=(), extra=())
    want = {k: float(v) for k, v in
            j_make_eval_step(jeval, jworld)(jstate, j_shard_batch(jworld, batch)).items()}
    assert want["_weight"] == 11.0

    world = comm.init({"data": 2}, devices=["cpu"])
    models = [LeNet() for _ in range(2)]
    for m in models:
        m.load_state_dict(params_from_jax(params, m))
    fns = [runner._classifier_fns(m, top5=True)[1] for m in models]
    init_fn, _ = make_train_step([runner._classifier_fns(m, False)[0] for m in models],
                                 tgoo.goo(LR), world)
    state = init_fn([dict(m.named_parameters()) for m in models])
    got = {k: float(v) for k, v in make_eval_step(fns, world)(state,
                                                              shard_batch(world, batch)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    # Without a mask: the plain mean over the ranks, no _weight.
    del batch["valid"]
    plain = make_eval_step(fns, world)(state, shard_batch(world, batch))
    assert "_weight" not in plain
    one = make_eval_step(fns[0])(state.__class__(step=0, params=state.params[0], opt_state=None),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(plain["loss"]), float(one["loss"]), rtol=1e-6)
