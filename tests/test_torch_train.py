"""mpit_tpu_torch's training slice against mpit_tpu's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances, with their reasons:

- ``lm_head_xent`` in f32: losses and gradients within 1e-5 (both sum
  f32 products in other orders). With bf16 products: losses within
  1e-5 (the products of bf16-rounded operands are exact in f32 on both
  sides), gradients within 1e-3 x max |grad| (the backward rounds ``g``
  to bf16 before its two products, so a last-bit difference before the
  rounding can move one element by a bf16 step).
- goo / goo_adam trajectories against optax within 1e-6, schedules
  within 1e-7: the same f32 arithmetic, fused differently.
- tiny GPT-2 in f32 from JAX's ``model.init``: losses within 1e-4,
  gradients within 1e-5 x max(1, max |grad|), parameters after three
  Adam steps within 1e-5 (``tests/test_torch_gpt2.py``'s reason: XLA
  and PyTorch sum matmuls and LayerNorm statistics in other orders).
- the whole slice, JAX's ``asyncsgd.gpt2.main`` against the port's on
  ``TestGPT2.TINY`` with lr 3e-2 behind a 2-step linear warmup: JAX
  trains in bf16 on its fake 8-device mesh (eight shards of one
  sequence, gradients averaged), the port on one rank; bf16 activations
  round at other points in the two frameworks (the three losses agree
  within 1e-4 at lr 0, within 3.1e-4 here), so they are held within
  2e-3. The wiring faults of ``main`` this guards against move a loss
  by 7e-3 or more: the second loss is 4.862 with the warmup (lr 0 at
  step 0) and 4.841 without it, the third 4.817 after the update and
  4.853 without one, and the three batches' losses at lr 0 differ by 7e-3
  to 1.5e-2, so batches out of order show.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.asyncsgd import gpt2 as jgpt2
from mpit_tpu.data.synthetic import SyntheticLM as JSyntheticLM
from mpit_tpu.models.gpt2 import GPT2 as JGPT2
from mpit_tpu.models.gpt2 import GPT2Config as JConfig
from mpit_tpu.ops.lm_head import lm_head_xent as j_xent
from mpit_tpu_torch.asyncsgd import gpt2 as tgpt2
from mpit_tpu_torch.asyncsgd.__main__ import main as cli_main
from mpit_tpu_torch.data import SyntheticLM
from mpit_tpu_torch.models import GPT2, GPT2Config
from mpit_tpu_torch.ops.lm_head import lm_head_xent
from mpit_tpu_torch.serve import params_from_jax
from mpit_tpu_torch.train import (
    Diverged,
    TrainState,
    hardened_loop,
    make_train_step,
    train_state_from_jax,
)

# The modules: the packages export functions of the same names over them.
jgoo = importlib.import_module("mpit_tpu.opt.goo")
jsched = importlib.import_module("mpit_tpu.opt.schedules")
tgoo = importlib.import_module("mpit_tpu_torch.opt.goo")
tsched = importlib.import_module("mpit_tpu_torch.opt.schedules")

TINY = [
    "--batch-size", "8", "--seq-len", "32", "--vocab-size", "128",
    "--num-layers", "2", "--num-heads", "2", "--d-model", "32",
]
# The whole-slice comparison's schedule: steps that move the loss by far
# more than the two frameworks' bf16 rounding does.
WHOLE_SLICE = ["--lr", "3e-2", "--schedule", "warmup", "--warmup-steps", "2"]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_lm_head_xent_matches_jax(compute):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((24, 32)).astype(np.float32)
    head = (rng.standard_normal((300, 32)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, 300, 24).astype(np.int32)
    ct = rng.standard_normal(24).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]

    def jloss(h, head):
        loss = j_xent(h, head, tgt, block_size=128, compute_dtype=jdt)
        return jnp.sum(loss * ct), loss

    (_, want_loss), want_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(h), jnp.asarray(head)
    )
    th, thead = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    loss = lm_head_xent(
        th, thead, torch.from_numpy(tgt), block_size=128, compute_dtype=getattr(torch, compute)
    )
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss), rtol=1e-5, atol=1e-5)
    (loss * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((th.grad, thead.grad), want_g):
        ref = np.asarray(ref)
        tol = 1e-5 if compute == "float32" else 1e-3 * np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


_RULES = {
    "adam": (lambda m, s: m.goo_adam(1e-2)),
    "adam_warmup_cosine": (lambda m, s: m.goo_adam(s.warmup_cosine(1e-2, 2, 6))),
    "adamw_warmup": (lambda m, s: m.goo_adam(s.warmup_constant(1e-2, 3), weight_decay=0.1)),
    "sgd": (lambda m, s: m.goo(0.1)),
    "momentum_wd_step": (lambda m, s: m.goo(s.step_decay(0.1, 2, 0.5), 0.9, weight_decay=1e-2)),
    "nesterov": (lambda m, s: m.goo(0.1, 0.9, nesterov=True)),
}


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_goo_trajectories_match_optax(rule):
    """Five steps on a small tree; the port's state maps onto optax's."""
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    jtx, ttx = _RULES[rule](jgoo, jsched), _RULES[rule](tgoo, tsched)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jtx.init(jp)

    @jax.jit
    def jstep(p, st, g):
        u, st = jtx.update(g, st, p)
        return optax.apply_updates(p, u), st

    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tst = ttx.init(tp)
    for g in grads:
        jp, jst = jstep(jp, jst, g)
        ttx.step(tp, {k: torch.tensor(v) for k, v in g.items()}, tst)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


@dataclasses.dataclass
class _Cfg:
    lr: float = 3e-4
    steps: int = 40
    schedule: str = ""
    warmup_steps: int = 0
    lr_end_scale: float = 0.0
    decay_every: int = 0
    decay_factor: float = 0.1
    schedule_horizon: int = 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(schedule="warmup", warmup_steps=7),
        dict(schedule="warmup_cosine", warmup_steps=5, lr_end_scale=0.1),
        dict(schedule="warmup_cosine", warmup_steps=0, schedule_horizon=25),
        dict(schedule="step", decay_every=6, decay_factor=0.5, warmup_steps=4),
    ],
    ids=["constant", "warmup", "warmup_cosine", "cosine_horizon", "warmup_step"],
)
def test_schedules_match_optax(kw):
    cfg = _Cfg(**kw)
    want, got = jsched.from_config(cfg), tsched.from_config(cfg)
    assert tsched.geometry(cfg) == jsched.geometry(cfg)
    counts = np.arange(50, dtype=np.int32)
    w = np.asarray(jax.jit(jax.vmap(want))(counts)) if callable(want) else np.full(50, want)
    g = np.array([got(int(c)) if callable(got) else got for c in counts])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    if kw.get("schedule") == "warmup":
        assert got(0) == 0.0  # called with the count before its increment


def test_synthetic_lm_tokens_bit_identical():
    for seed, vocab in ((0, 128), (3, 50257)):
        j, t = JSyntheticLM(vocab_size=vocab, seed=seed), SyntheticLM(vocab_size=vocab, seed=seed)
        np.testing.assert_array_equal(j.successors, t.successors)
        for skip in (0, 5):
            jb, tb = j.batches(4, 16, skip=skip), t.batches(4, 16, skip=skip)
            for _ in range(2):
                np.testing.assert_array_equal(next(jb)["tokens"], next(tb)["tokens"])
    assert t.uniform_loss == j.uniform_loss and t.optimal_loss == j.optimal_loss


@pytest.fixture(scope="module")
def tiny_jax_run():
    """JAX's tiny f32 GPT-2: its ``model.init`` params and ``goo_adam``
    state (numpy), a token batch [2, 17], and the reference trajectory:
    loss and grads at the start, then three ``goo_adam`` steps (the
    losses and the final params)."""
    jcfg = JConfig.tiny(dtype=jnp.float32, max_seq_len=16)
    jmodel = JGPT2(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    jtx = jgoo.goo_adam(1e-3)
    st0 = jtx.init(params)
    vg = jax.value_and_grad(lambda p, t: JGPT2.fused_loss_fn(jmodel, p, t))

    @jax.jit
    def step(p, st):
        loss, g = vg(p, tokens)
        u, st = jtx.update(g, st, p)
        return optax.apply_updates(p, u), st, loss, g

    p, st, losses, grads0 = params, st0, [], None
    for _ in range(3):
        p, st, loss, g = step(p, st)
        losses.append(float(loss))
        grads0 = g if grads0 is None else grads0
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        params=as_np(params), opt_state=as_np(st0), tokens=tokens, losses=losses,
        grads0=params_from_jax(as_np(grads0)), final=params_from_jax(as_np(p)),
    )


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_tiny_gpt2_loss_grads_and_adam_steps_match_jax(tiny_jax_run, remat):
    """Loss and gradients at JAX's initial params, then three Adam steps.

    The key third of ``qkv``'s bias has a gradient that is exactly zero
    in exact arithmetic (a softmax does not change when one constant is
    added to every score of a row), so in f32 it is rounding noise of
    about 1e-7, different in each framework; Adam divides it by its own
    root mean square and moves those entries by up to lr each step in
    directions neither side controls. Those 64 entries are held to zero
    gradient (1e-5) and to within 3 steps of lr; every other entry of
    every parameter to 1e-5."""
    ref = tiny_jax_run
    state = train_state_from_jax(ref["params"], ref["opt_state"], 0)
    model = GPT2(GPT2Config.tiny(dtype=torch.float32, max_seq_len=16, remat=remat))
    state = state.bind(model)
    ttok = torch.from_numpy(ref["tokens"]).long()

    tloss = GPT2.fused_loss_fn(model, ttok)
    tgrads = torch.autograd.grad(tloss, list(state.params.values()))
    np.testing.assert_allclose(tloss.item(), ref["losses"][0], rtol=1e-4, atol=1e-4)
    for (name, _), g in zip(state.params.items(), tgrads):
        want = ref["grads0"][name].numpy()
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=name
        )

    _, step_fn = make_train_step(
        lambda p, b: (GPT2.fused_loss_fn(model, b["tokens"]), {}), tgoo.goo_adam(1e-3)
    )
    for want_loss in ref["losses"]:
        state, metrics = step_fn(state, {"tokens": ttok})
        np.testing.assert_allclose(metrics["loss"].item(), want_loss, rtol=1e-4, atol=1e-4)
    assert state.step == 3 and state.opt_state.count == 3
    d = model.cfg.d_model
    for name, p in state.params.items():
        got, want = p.detach().numpy(), ref["final"][name].numpy()
        if name.endswith("qkv.bias"):
            key = slice(d, 2 * d)
            assert np.abs(ref["grads0"][name].numpy()[key]).max() <= 1e-5
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=3 * 1e-3)
            got, want = np.delete(got, np.s_[d : 2 * d]), np.delete(want, np.s_[d : 2 * d])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_train_state_from_jax_maps_optimizer_state():
    """Adam moments (replicated tree and the flat ZeRO-1 vector of one
    rank) and the SGD momentum land under the params' names."""
    rng = np.random.default_rng(3)
    params = {"wte": rng.standard_normal((6, 4)).astype(np.float32),
              "block_0": {"ln1": {"scale": rng.standard_normal(4).astype(np.float32)}}}
    mu = jax.tree.map(lambda x: x * 2, params)
    nu = jax.tree.map(lambda x: x * x, params)
    adam = optax.ScaleByAdamState(count=np.int32(7), mu=mu, nu=nu)
    st = train_state_from_jax(params, (adam, optax.EmptyState()), 7)
    assert st.step == 7 and st.opt_state.count == 7
    assert list(st.opt_state.mu) == list(st.params) and set(st.params) == {
        "blocks.0.ln1.scale", "wte"
    }
    np.testing.assert_array_equal(st.opt_state.mu["wte"].numpy(), mu["wte"])
    # ZeRO-1 on one rank: leaves in sorted-key order, each padded to 128.
    flat = np.zeros(256, np.float32)
    flat[:4], flat[128:152] = nu["block_0"]["ln1"]["scale"], nu["wte"].ravel()
    st = train_state_from_jax(params, (optax.ScaleByAdamState(np.int32(1), flat, flat),), 1)
    np.testing.assert_array_equal(st.opt_state.nu["wte"].numpy(), nu["wte"])
    np.testing.assert_array_equal(
        st.opt_state.nu["blocks.0.ln1.scale"].numpy(), nu["block_0"]["ln1"]["scale"]
    )
    sgd = jgoo.GooState(momentum=mu, count=np.int32(4))
    st = train_state_from_jax(params, sgd, 4)
    assert st.opt_state.count == 4
    np.testing.assert_array_equal(st.opt_state.momentum["wte"].numpy(), mu["wte"])
    st = train_state_from_jax(params, jgoo.GooState(momentum=(), count=()), 0)
    assert st.opt_state.momentum is None and st.opt_state.count is None


@pytest.fixture(scope="module")
def jax_tiny_run():
    """JAX's ``asyncsgd.gpt2.main`` on ``TestGPT2.TINY`` for 3 steps, and
    its seed-0 initial parameters (as its ``init_params`` builds them)."""
    out = jgpt2.main(["--steps", "3", "--log-every", "1", *TINY, *WHOLE_SLICE])
    cfg = jgpt2.GPT2TrainConfig(
        vocab_size=128, seq_len=32, num_layers=2, num_heads=2, d_model=32
    )
    jmodel = JGPT2(cfg.model_config())
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"]
    return out, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("flash", ["false", "true"])
def test_whole_slice_matches_jax_gpt2_main(jax_tiny_run, flash):
    want, params = jax_tiny_run
    out = tgpt2.main(
        ["--steps", "3", "--log-every", "1", "--device", "cpu", "--flash", flash, *TINY,
         *WHOLE_SLICE],
        initial_params=params_from_jax(params),
    )
    assert out["tier"] == want["tier"] == "shard_map+zero1"
    assert out["steps"] == 3 and len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], want["losses"], rtol=0, atol=2e-3)
    assert out["uniform_loss"] == want["uniform_loss"]


def test_cli_trains_tiny_on_the_cpu(capsys):
    assert cli_main(["gpt2", "--device", "cpu", "--steps", "4", "--log-every", "2", *TINY]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"steps": 4' in line and '"attention": "plain"' in line


@pytest.mark.parametrize(
    "argv",
    [
        ["mnist", "--mode", "elastic"], ["imagenet", "--augment", "true"], ["resnet"],
        ["gpt2", "--mesh", "data=1,model=2"],
        ["gpt2", "--mesh", "seq=2"], ["gpt2", "--mesh", "data=1,pipe=2"],
        ["gpt2", "--mesh", "data=1,expert=2"], ["gpt2", "--data-dir", "/d"],
        ["gpt2", "--ckpt-dir", "/c"], ["gpt2", "--save-dense", "/s.npz"],
        ["gpt2", "--resume-dense", "/s.npz"], ["gpt2", "--profile-dir", "/p"],
        ["gpt2", "--sentinel", "true"], ["gpt2", "--native", "true"],
        ["gpt2", "--easgd", "true"], ["gpt2", "--mode", "parity"],
        ["gpt2", "--mode", "elastic"], ["gpt2", "--ulysses", "true"],
        ["gpt2", "--prefetch-workers", "2"], ["gpt2", "--prefetch-max-depth", "2"],
        ["gpt2", "--moe-experts", "16"], ["gpt2", "--pp-schedule", "1f1b"],
        ["gpt2", "--fsdp-axis", "data"], ["gpt2", "--easgd-beta", "0.5"],
        ["gpt2", "--max-restores", "3"], ["gpt2", "--ckpt-every", "5"],
        ["gpt2", "--lease-s", "2"], ["gpt2", "--augment", "true"],
    ],
    ids=lambda a: "_".join(a).replace("-", ""),
)
def test_later_slice_flags_raise(argv):
    # The ResNet slice brought ``resnet`` and ``--augment``, the
    # checkpoint and elastic slice ``--mode elastic`` for mnist and the
    # checkpoint, dense and liveness flags: their cases (ids kept) now
    # hold the refusals that stay around them. EASGD under SPMD came with
    # its slice; gpt2 refuses ``--easgd`` because JAX's gpt2 ignores it.
    small = ["--image-size", "32", "--num-classes", "10"]
    argv = {"resnet": ["resnet", "--mode", "parity"],
            "imagenet_augment_true": ["imagenet", "--augment", "true", "--augment-mode",
                                      "rrc"],
            "mnist_mode_elastic": ["imagenet", "--mode", "elastic", *small],
            "gpt2_ckptdir_/c": ["mnist", "--easgd", "true", "--native", "true"],
            "gpt2_savedense_/s.npz": ["gpt2", "--save-dense", "/s.npz", "--zero1", "false"],
            "gpt2_resumedense_/s.npz": ["resnet", "--resume-dense", "/s.npz", *small],
            "gpt2_easgdbeta_0.5": ["resnet", "--mode", "elastic", *small],
            "gpt2_maxrestores_3": ["mnist", "--mode", "elastic", "--native", "true"],
            "gpt2_ckptevery_5": ["mnist", "--mode", "elastic", "--profile-dir", "/p"],
            "gpt2_leases_2": ["mnist", "--mode", "elastic", "--sentinel", "true",
                              "--native", "true"],
            "gpt2_profiledir_/p": ["gpt2", "--profile-dir", "/p", "--mode", "parity"],
            "gpt2_sentinel_true": ["gpt2", "--sentinel", "true", "--native", "true"],
            # TP training and the CP tier train on the model, fsdp and seq
            # axes now: their cases hold the 3-D meshes, which stay refused.
            "gpt2_mesh_data=1,model=2": ["gpt2", "--mesh", "data=1,seq=2,model=2"],
            "gpt2_mesh_seq=2": ["gpt2", "--mesh", "model=2,pipe=2"],
            }.get("_".join(argv).replace("-", ""), argv)
    # The pipe and expert axes, the 3-D meshes and the pp/ep flags name
    # the other training tiers (ROADMAP.md §A 10); --ulysses off the CP
    # tier and --fsdp-axis off the pjit tier are what JAX's tier ignores.
    match = (r"need --data-dir" if argv[0] == "imagenet" and "rrc" in argv
             else r"§A 10" if "--mesh" in argv or "--moe-experts" in argv
             or "--pp-schedule" in argv
             else r"requires the cp tier" if "--ulysses" in argv
             else r"JAX's other tiers ignore the flag" if "--fsdp-axis" in argv
             else r"slice|SPMD-only|mnist only|ZeRO-1 DP layout|ignores --easgd"
                  r"|profile window is the SPMD")
    with pytest.raises(SystemExit, match=match):
        cli_main([*argv[:1], "--device", "cpu", *argv[1:]] if argv[0] == "gpt2" else argv)


def test_gpt2_main_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt2.main(["--steps", "1", *TINY])


def test_loop_raises_on_a_non_finite_loss():
    """With no checkpoint to restore, a divergence propagates."""
    state = TrainState(step=0, params={}, opt_state=None)

    def step_fn(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(float("nan") if state.step == 3 else 1.0)}

    batches = iter({"x": np.zeros(2, np.float32)} for _ in range(10))
    with pytest.raises(Diverged, match="step 3"):
        hardened_loop(state, step_fn, batches, steps=6, device="cpu", log_every=1, fetch_lag=1)
