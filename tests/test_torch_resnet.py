"""mpit_tpu_torch's ResNet slice (the norms, the model, the converter,
the flat layout, the stateful step and eval step, the workload) against
mpit_tpu's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages; the
ResNet is cut to ``stage_sizes=(1, 1, 1, 1)`` at 32×32 with 10 classes.
Tolerances, with their reasons:

- the norms in f32 (outputs, running statistics, gradients of the
  input, ``scale`` and ``bias``): within ``1e-5·max(1, max |want|)``
  (sums over the batch in other orders);
- the norms in bf16: the statistics as in f32 (both square and sum the
  same bf16 values in f32); the output within one bf16 step of its
  magnitude, ``2^-7·max(1, max |y|)`` (the scale-shift form rounds
  ``a`` and ``b`` to bf16 and, in PyTorch, the product before the sum;
  XLA may fuse the two); the gradients within ``2^-5·max(1, max |g|)``:
  XLA sums the bf16 products of ``scale``'s gradient in bf16 (0.019 of
  max |g| from the f32 gradient at this input; PyTorch, summing in
  f32, 0.003);
- the ResNet in f32 from ``params_from_jax``, both stems, train and
  eval: logits within ``1e-4·max(1, max |logits|)`` and the new
  statistics within ``1e-4·max(1, max |stat|)`` (XLA and cuDNN-free
  PyTorch sum the convolutions in other orders, and five norms carry
  the difference through their ``rsqrt``);
- the ResNet's default bf16 forward: within ``0.1·max(1, max
  |logits|)`` of JAX's bf16 forward. Every conv and norm output is
  rounded to bf16 (a step of 2^-8 relative) after sums in other orders,
  and 14 norms over four images divide by the deviations of few values:
  at this input each bf16 forward parts from the f32 one by 0.07 of
  max |logits|, and the two by 0.054;
- three f32 goo steps (lr 0.01, momentum 0.9, weight decay 1e-4) on
  eight images a rank, one rank and at p 4 (``psum``, ZeRO-1), against
  JAX's stateful ``make_train_step`` on the fake CPU mesh: losses within
  3e-5 relative, parameters and the rank-averaged statistics within
  ``3e-4·max(1, max |x|)``. Observed over 1 to 8 PyTorch threads (each
  sums in its own order): losses 1.2e-6 on one rank and 5.5e-6 at p 4,
  parameters 4e-7 and 6.6e-5 (at p 4 each norm sees eight images, and
  the norms' gradients carry the sums' orders into the updates). At lr
  0.1 the first losses' 1e-6 grows to 2e-5 in three steps, and the
  parameters part by up to 6% of their change; The port's ``ring`` equals its ``psum`` bit
  for bit at p 2 (one addition, one order);
- the stateful eval step at p 2 with a padded mask: within 1e-5.
"""

from __future__ import annotations

import importlib

import flax.linen as fnn
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu
from mpit_tpu.asyncsgd import runner as jrunner
from mpit_tpu.data import shard_batch as j_shard_batch
from mpit_tpu.models import ResNet50 as JResNet50
from mpit_tpu.models import ScaleShiftBatchNorm as JScaleShift
from mpit_tpu.train import make_eval_step as j_make_eval_step
from mpit_tpu.train import make_train_step as j_make_train_step
from mpit_tpu_torch import comm
from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.__main__ import main as cli_main
from mpit_tpu_torch.data import shard_batch, synthetic_imagenet
from mpit_tpu_torch.models import BatchNorm, ResNet50, ScaleShiftBatchNorm
from mpit_tpu_torch.models.layers import params_from_jax
from mpit_tpu_torch.models.resnet import space_to_depth
from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
from mpit_tpu_torch.train import make_eval_step, make_train_step

jgoo = importlib.import_module("mpit_tpu.opt.goo")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")
tresnet = importlib.import_module("mpit_tpu_torch.asyncsgd.resnet")

SIZE, CLASSES, STAGES = 32, 10, (1, 1, 1, 1)
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4
CPU = ["--device", "cpu"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol, err_msg=what)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# ---- the norms ---------------------------------------------------------------

_NORMS = {"scale_shift": (JScaleShift, ScaleShiftBatchNorm), "flax": (fnn.BatchNorm, BatchNorm)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", sorted(_NORMS))
def test_norm_matches_jax(impl, dtype):
    jcls, tcls = _NORMS[impl]
    rng = np.random.RandomState(0)
    c = 16
    x = (rng.randn(8, 6, 6, c) * 3 + 1.5).astype(np.float32)
    cot = rng.randn(8, 6, 6, c).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jdt)

    def jfwd(p, xx, train):
        m = jcls(use_running_average=not train, dtype=jdt)
        if not train:
            return m.apply({"params": p, "batch_stats": stats}, xx), stats
        y, mut = m.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    def jloss(p, xx):
        y, _ = jfwd(p, xx, True)
        return jnp.sum(y.astype(jnp.float32) * cot)

    tdt = getattr(torch, dtype)
    norm = tcls(c, dtype=tdt)
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    for train in (True, False):
        want_y, want_s = _np(jfwd(params, xj, train))
        y = norm(_nchw(xt), train=train)
        assert y.dtype == tdt
        got_y = y.permute(0, 2, 3, 1).float().detach().numpy()
        f32 = dtype == "float32"
        _close(got_y, np.asarray(want_y, np.float32), 1e-5 if f32 else 2**-7, f"{impl} y")
        for k in ("mean", "var"):
            _close(getattr(norm, k).numpy(), want_s[k], 1e-5, f"{impl} {k}")
        if train:
            loss = (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum()
            gx, gs, gb = torch.autograd.grad(loss, [xt, norm.scale, norm.bias])
            jg_p, jg_x = _np(jax.grad(jloss, argnums=(0, 1))(params, xj))
            rel = 1e-5 if f32 else 2**-5
            _close(gx.float().numpy(), np.asarray(jg_x, np.float32), rel, f"{impl} dx")
            _close(gs.numpy(), jg_p["scale"], rel, f"{impl} dscale")
            _close(gb.numpy(), jg_p["bias"], rel, f"{impl} dbias")
            norm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})


def test_norm_refuses_cross_replica_stats():
    with pytest.raises(NotImplementedError, match="one after another"):
        ScaleShiftBatchNorm(8, axis_name="data")


# ---- the model and the converter -------------------------------------------------


def test_space_to_depth_channel_order():
    """Every input value distinct (its channel, row and column coded in
    it), so a wrong order of the 2×2 cell's pixels or channels shows."""
    b, h, w, c = 2, 4, 6, 3
    x = np.arange(b * h * w * c, dtype=np.float32).reshape(b, h, w, c)
    got = space_to_depth(torch.from_numpy(x)).numpy()
    want = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4 * c)
    np.testing.assert_array_equal(got, want)
    for dy in range(2):
        for dx in range(2):
            for ch in range(c):
                assert got[1, 1, 2, (dy * 2 + dx) * c + ch] == x[1, 2 + dy, 4 + dx, ch]
    with pytest.raises(ValueError, match="even"):
        space_to_depth(torch.zeros(1, 3, 4, 3))


def _jmodel(stem="s2d", norm=JScaleShift, f32=True):
    dt = jnp.float32 if f32 else jnp.bfloat16
    return JResNet50(num_classes=CLASSES, dtype=dt, stage_sizes=STAGES, norm_dtype=dt,
                     stem=stem, norm=norm)


def _tmodel(stem="s2d", norm="scale_shift", f32=True):
    dt = torch.float32 if f32 else torch.bfloat16
    return ResNet50(CLASSES, dt, STAGES, dt, stem, norm)


def _variables(jmodel, seed=0):
    """Numpy values at the shapes of ``jmodel``'s variables (from
    ``jax.eval_shape``, nothing compiled): kernels with variance
    ``1/fan_in``, every norm's ``scale`` and ``var`` in [0.5, 1.5] (none
    zero, so each block's last norm and conv reach the output), biases
    and means small."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


def _images(n=4, seed=1):
    return np.random.RandomState(seed).randn(n, SIZE, SIZE, 3).astype(np.float32)


def _jforward(jm, with_eval: bool):
    """One compiled program: the train forward's logits and statistics,
    and with ``with_eval`` the eval forward through those statistics."""

    def f(p, s, xx):
        logits, mut = jm.apply({"params": p, "batch_stats": s}, xx, mutable=["batch_stats"])
        new = mut["batch_stats"]
        ev = jm.apply({"params": p, "batch_stats": new}, xx, train=False) if with_eval else None
        return logits, new, ev

    return jax.jit(f)


@pytest.fixture(scope="module")
def forward_cases():
    """JAX's logits and new statistics: each stem in f32 (train, and
    eval through the train forward's statistics), the s2d stem in bf16
    (train), and the flax norm's ResNet in f32 (train)."""
    x = _images()
    out = {}
    for stem in ("s2d", "conv7"):
        params, stats = _variables(_jmodel(stem))
        logits, new, ev = _np(_jforward(_jmodel(stem), True)(params, stats, x))
        out[stem] = dict(params=params, stats=stats, logits=logits, new=new, eval=ev)
    case = out["s2d"]
    bf16, _, _ = _jforward(_jmodel(f32=False), False)(case["params"], case["stats"], x)
    case["bf16"] = np.asarray(bf16, np.float32)
    params, stats = _variables(_jmodel(norm=fnn.BatchNorm))
    logits, new, _ = _np(_jforward(_jmodel(norm=fnn.BatchNorm), False)(params, stats, x))
    out["flax"] = dict(params=params, stats=stats, logits=logits, new=new)
    return x, out


def _load(model, params, stats):
    model.load_state_dict(params_from_jax(params, model, stats))
    return model


def _stats_close(model, want, rel):
    got = {k: v.numpy() for k, v in model.named_buffers()}
    flat = _flat(want)
    assert set(got) == set(flat)
    for k in got:
        _close(got[k], flat[k], rel, k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("stem", ["s2d", "conv7"])
def test_resnet_f32_forward_matches_jax(forward_cases, stem):
    x, cases = forward_cases
    case = cases[stem]
    model = _load(_tmodel(stem), case["params"], case["stats"])
    with torch.no_grad():
        logits = model(torch.from_numpy(x), train=True)
        _close(logits.numpy(), case["logits"], 1e-4, "train logits")
        _stats_close(model, case["new"], 1e-4)
        _close(model(torch.from_numpy(x), train=False).numpy(), case["eval"], 1e-4, "eval")


def test_resnet_bf16_forward_within_bf16_tolerance(forward_cases):
    x, cases = forward_cases
    model = _load(_tmodel(f32=False), cases["s2d"]["params"], cases["s2d"]["stats"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    _close(got.numpy(), cases["s2d"]["bf16"], 0.1, "bf16 logits")


def test_resnet_flax_norm_forward_matches_jax(forward_cases):
    x, cases = forward_cases
    case = cases["flax"]
    model = _tmodel(norm="flax")
    assert "BatchNorm_0.scale" in dict(model.named_parameters())
    _load(model, case["params"], case["stats"])
    with torch.no_grad():
        _close(model(torch.from_numpy(x), train=True).numpy(), case["logits"], 1e-4, "logits")
    _stats_close(model, case["new"], 1e-4)


def test_converter_refuses_a_tree_without_its_statistics(forward_cases):
    _, cases = forward_cases
    model = _tmodel()
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax(cases["s2d"]["params"], model, {})
    with pytest.raises(ValueError, match="no such parameter"):
        params_from_jax(cases["s2d"]["params"], _tmodel(norm="flax"), cases["s2d"]["stats"])


def test_flat_layout_follows_ravel_pytree_leaf_order(forward_cases):
    _, cases = forward_cases
    params = cases["s2d"]["params"]
    state = params_from_jax(params, _tmodel())
    layout = FlatLayout(state)
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    assert layout.names == [".".join(k.key for k in path) for path, _ in leaves]
    jflat, _ = jax.flatten_util.ravel_pytree(params)
    flat, joff = layout.ravel(state).numpy(), 0
    for (path, leaf), name in zip(leaves, layout.names):
        n = np.asarray(leaf).size
        seg, jseg = flat[layout.offsets[name]: layout.offsets[name] + n], jflat[joff: joff + n]
        if np.asarray(leaf).ndim == 4:  # OIHW here, HWIO there: the same multiset
            np.testing.assert_array_equal(np.sort(seg), np.sort(np.asarray(jseg)))
        else:
            np.testing.assert_array_equal(seg, np.asarray(jseg), err_msg=name)
        joff += n
    # Full size: JAX's 161 leaves (sorted as strings: Bottleneck_10 before
    # Bottleneck_2), 25,559,912 parameters, 49,924 shard rows at p 4.
    full = FlatLayout(dict(ResNet50(device="meta").named_parameters()))
    assert len(full.names) == 161
    assert sum(int(np.prod(s)) for s in full.shapes.values()) == 25_559_912
    assert padded_len(full.total, 4) // (4 * 128) == 49_924
    blocks = [n.split(".")[0] for n in full.names if n.startswith("Bottleneck_")]
    assert blocks.index("Bottleneck_10") < blocks.index("Bottleneck_2")
    conv7 = ResNet50(device="meta", stem="conv7")
    assert sum(p.numel() for p in conv7.parameters()) == 25_557_032
    assert sum(b.numel() for b in conv7.buffers()) == 53_120
    assert len(list(conv7.buffers())) == 106


# ---- the stateful step -----------------------------------------------------------

_STEP_CASES = {"one_rank": (1, "psum"), "p4_psum": (4, "psum")}


def _step_batches(p, n=3):
    """Eight images a rank: at two, the last stage's statistics (one
    pixel a channel) are so nearly degenerate that the 1e-6 by which the
    two frameworks' first losses part grows to 2e-3 in one step."""
    stream = synthetic_imagenet(image_size=SIZE, num_classes=CLASSES, seed=0).batches(8 * p)
    return [next(stream) for _ in range(n)]


@pytest.fixture(scope="module")
def step_init():
    """The steps' start, drawn by numpy as flax initialises the model:
    kernels normal with variance ``1/fan_in`` cut at two deviations,
    every ``scale`` 1 but each block's last (0), biases 0, the running
    averages 0 and 1. From :func:`_variables`' values (every ``scale``
    nonzero, biases not 0), a loss that falls from 2.9 to 1.3 in three
    steps parts by 4e-4 relative between the frameworks."""
    params, stats = _variables(_jmodel(), seed=1)

    def init(path, leaf):
        keys = [k.key for k in path]
        if keys[-1] == "kernel":
            std = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
            return np.clip(leaf, -2 * std, 2 * std)
        if keys[-1] in ("scale", "var"):
            last = keys[-1] == "scale" and keys[-2] == "ScaleShiftBatchNorm_2"
            return np.full_like(leaf, 0.0 if last else 1.0)
        return np.zeros_like(leaf)

    return (jax.tree_util.tree_map_with_path(init, params),
            jax.tree_util.tree_map_with_path(init, stats))


@pytest.fixture(scope="module")
def jax_steps(step_init):
    params, stats = step_init
    jm = _jmodel()

    def loss_fn(p, s, b):
        logits, mut = jm.apply({"params": p, "batch_stats": s}, b["image"],
                               mutable=["batch_stats"])
        return jrunner.softmax_xent(logits, b["label"]), {}, mut["batch_stats"]

    out = {}
    for case, (p, mode) in _STEP_CASES.items():
        world = mpit_tpu.init({"data": p}, devices=jax.devices()[:p], set_default=False)
        init_fn, step_fn, _ = j_make_train_step(
            loss_fn, jgoo.goo(LR, MOMENTUM, weight_decay=WD), world, zero1=True,
            stateful=True, grad_sync=mode, donate=False)
        state = init_fn(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats))
        losses = []
        for b in _step_batches(p):
            state, m = step_fn(state, j_shard_batch(world, b))
            losses.append(float(m["loss"]))
        out[case] = (losses, _np(state.params), _np(state.extra), world, state)
    return out


def _port_steps(params, stats, p, mode):
    models = [_load(_tmodel(), params, stats) for _ in range(p)]
    fns = [runner._classifier_fns(m, top5=False, stateful=True) for m in models]
    world = None if p == 1 else comm.init({"data": p}, devices=["cpu"])
    init_fn, step_fn = make_train_step(
        fns[0][0] if world is None else [f[0] for f in fns],
        tgoo.goo(LR, MOMENTUM, weight_decay=WD), world, stateful=True, grad_sync=mode)
    named = [dict(m.named_parameters()) for m in models]
    bufs = [dict(m.named_buffers()) for m in models]
    state = (init_fn(named[0], bufs[0]) if world is None else init_fn(named, bufs))
    losses = []
    for b in _step_batches(p):
        b = {k: torch.from_numpy(v) for k, v in b.items()} if world is None else shard_batch(
            world, b)
        state, m = step_fn(state, b)
        losses.append(m["loss"].item())
    return losses, state, models, fns, world


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_three_stateful_steps_match_jax(step_init, jax_steps, case):
    p, mode = _STEP_CASES[case]
    losses, state, models, _, _ = _port_steps(*step_init, p, mode)
    want_losses, want_params, want_stats, _, _ = jax_steps[case]
    np.testing.assert_allclose(losses, want_losses, rtol=3e-5, atol=0)
    assert state.replicas_equal()
    want = params_from_jax(want_params, models[0], want_stats)
    got = {**dict(models[-1].named_parameters()), **dict(models[-1].named_buffers())}
    for name, w in want.items():
        _close(got[name].detach().numpy(), w.numpy(), 3e-4, name)
    # The statistics moved from their initial 0 and 1.
    assert not np.allclose(got["ScaleShiftBatchNorm_0.mean"].numpy(), 0.0)


def test_stateful_ring_equals_psum_and_replicas_stay_equal(step_init):
    params, stats = step_init
    psum, s_psum, m_psum, _, _ = _port_steps(params, stats, 2, "psum")
    ring, s_ring, m_ring, _, _ = _port_steps(params, stats, 2, "ring")
    assert ring == psum
    assert torch.equal(s_psum.flat.params, s_ring.flat.params)
    for (name, a), b in zip(m_psum[1].named_buffers(), m_ring[1].buffers()):
        assert torch.equal(a, b), name
    assert s_ring.replicas_equal()
    # A rank's buffers apart from the others' are found.
    s_ring.extra[1]["ScaleShiftBatchNorm_0.var"][0] += 1.0
    assert not s_ring.replicas_equal()


def test_stateful_eval_step_matches_jax_with_a_padded_batch(jax_steps):
    jm = _jmodel()
    batch = synthetic_imagenet(image_size=SIZE, num_classes=CLASSES, seed=5).eval_batch(8)
    batch["valid"] = np.asarray([1.0] * 6 + [0.0] * 2, np.float32)

    def jeval(p, s, b):
        logits = jm.apply({"params": p, "batch_stats": s}, b["image"], train=False)
        v = b["valid"]
        return {"loss": jrunner.softmax_xent(logits, b["label"], v),
                "top1": jrunner.accuracy(logits, b["label"], v),
                "top5": jrunner.topk_accuracy(logits, b["label"], 5, v),
                "_weight": jnp.sum(v)}

    _, want_params, want_stats, _, _ = jax_steps["p4_psum"]
    jworld = mpit_tpu.init({"data": 2}, devices=jax.devices()[:2], set_default=False)
    jstate = mpit_tpu.train.TrainState(step=jnp.zeros((), jnp.int32),
                                       params=jax.tree.map(jnp.asarray, want_params),
                                       opt_state=(), extra=jax.tree.map(jnp.asarray, want_stats))
    want = {k: float(v) for k, v in
            j_make_eval_step(jeval, jworld)(jstate, j_shard_batch(jworld, batch)).items()}
    assert want["_weight"] == 6.0

    world = comm.init({"data": 2}, devices=["cpu"])
    models = [_load(_tmodel(), want_params, want_stats) for _ in range(2)]
    fns = [runner._classifier_fns(m, top5=True, stateful=True) for m in models]
    init_fn, _ = make_train_step([f[0] for f in fns], tgoo.goo(LR), world, stateful=True)
    state = init_fn([dict(m.named_parameters()) for m in models],
                    [dict(m.named_buffers()) for m in models])
    before = {k: v.clone() for k, v in models[0].named_buffers()}
    got = make_eval_step([f[1] for f in fns], world, stateful=True)(state,
                                                                   shard_batch(world, batch))
    got = {k: float(v) for k, v in got.items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    for k, v in models[0].named_buffers():  # the eval leaves the statistics alone
        assert torch.equal(v, before[k]), k


# ---- the workload ------------------------------------------------------------------

TINY = ["--image-size", str(SIZE), "--num-classes", str(CLASSES), "--batch-size", "8",
        "--eval-batch", "8", "--log-every", "1", "--lr", "0.01", *CPU]


def _json_line(capsys):
    import json

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def two_stage_resnet(monkeypatch):
    """The workload's model cut to two stages (0.47 M parameters): its
    full depth (25.6 M) costs the CLI tests minutes on a loaded CPU and
    adds nothing to what they check (the flags, the data, the stateful
    step and eval through ``main``)."""
    monkeypatch.setattr(tresnet, "ResNet50",
                        lambda *a, **kw: ResNet50(*a, stage_sizes=(1, 1), **kw))


@pytest.mark.parametrize("extra", [[], ["--mesh", "data=4", "--grad-sync", "ring_q8",
                                        "--bn-impl", "flax", "--augment", "true"]],
                         ids=["one_rank", "p4_ring_q8_flax_augment"])
def test_cli_trains_resnet_on_the_cpu(capsys, two_stage_resnet, extra):
    assert cli_main(["resnet", "--steps", "2", *TINY, *extra]) == 0
    out = _json_line(capsys)
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert set(out["eval"]) == {"loss", "top1", "top5"}
    if extra:
        assert out["ranks"] == 4 and out["grad_sync"] == "ring_q8_plain"
        assert out["replicas_identical"]


@pytest.mark.parametrize(
    "argv, match",
    [(["resnet", "--mode", "parity"], "SPMD-only"),
     (["resnet", "--bn-impl", "batch"], "bn-impl"),
     (["resnet", "--native", "true"], "data-pipeline slice"),
     (["resnet", "--augment", "true", "--augment-mode", "rrc"], "need --data-dir"),
     (["resnet", "--train-size", "24"], "need --data-dir")],
    ids=["parity", "bn_impl", "native", "rrc", "train_size"],
)
def test_resnet_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main([*argv, *CPU])


def test_resnet_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tresnet.main(["--steps", "1"])
