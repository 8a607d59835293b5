"""mpit_tpu_torch's flash attention against mpit_tpu's, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX function
and the port's. On the CPU the port's autograd Function runs the three
kernels' plain versions; the JAX side runs its XLA reference, and in one
case its Pallas kernels in interpret mode (forward, dq and dk/dv).

Tolerances: the plain forward against ``reference_attention_with_lse``
within 2e-5 (f32; XLA and PyTorch sum in other orders), gradients
against the Pallas kernels within 1e-4 (as ``tests/test_ops.py`` holds
those kernels against XLA's autodiff), the merge within 3e-5.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu_torch.models import default_attention

# The modules, not the functions of the same name that the packages
# export over them.
jfa = importlib.import_module("mpit_tpu.ops.flash_attention")
tfa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [
        (64, 64, 0, 0, True),
        (48, 80, 100, 60, True),  # offsets: partly visible, ragged lengths
        (32, 32, 0, 64, True),  # the key block wholly in the future
        (40, 40, 0, 0, False),
    ],
)
def test_plain_forward_matches_jax_reference(tq, tk, q_off, k_off, causal):
    q, = _arrays((2, tq, 3, 16), 1, tq + k_off)
    k, v = _arrays((2, tk, 3, 16), 2, tk + q_off)
    ref = jax.jit(
        lambda q, k, v: jfa.reference_attention_with_lse(
            q, k, v, q_offset=q_off, k_offset=k_off, causal=causal
        )
    )
    want_o, want_lse = ref(q, k, v)
    o, lse = tfa.flash_attention_block(
        *map(torch.from_numpy, (q, k, v)), q_offset=q_off, k_offset=k_off, causal=causal
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5, atol=2e-5)
    if k_off >= q_off + tq:
        assert (o == 0).all() and (lse == -1e30).all()


def test_autograd_matches_jax_pallas_interpret():
    """The port's Function (plain forward, dq and dk/dv) against
    ``jax.grad`` through the Pallas kernels in interpret mode; the loss
    has an lse term, so a non-zero lse cotangent folds into delta."""
    q, k, v, w = _arrays((1, 128, 2, 64), 4, 0)
    c, = _arrays((1, 2, 128), 1, 1)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_block(
            q, k, v, q_offset=64, k_offset=0, block_q=64, block_k=64, interpret=True
        )
        return jnp.sum(o * w) + jnp.sum(jnp.sin(lse) * c)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_block(
        tq, tk, tv, q_offset=64, k_offset=0, block_q=64, block_k=64
    )
    (o * torch.from_numpy(w)).sum().add((lse.sin() * torch.from_numpy(c)).sum()).backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_kernel_plain_backward_matches_autograd_of_plain_forward():
    """dq and dk/dv's plain versions equal torch autograd through the
    plain forward (f32, 1e-5): the Flash-2 algebra, delta and the lse
    fold, checked without either framework's kernels."""
    q, k, v, w = (torch.from_numpy(x) for x in _arrays((2, 24, 2, 16), 4, 5))
    g_lse = torch.from_numpy(_arrays((2, 2, 24), 1, 6)[0])
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = tfa.reference_attention_with_lse(qr, kr, vr, q_offset=8, k_offset=0)
    (o * w).sum().add((lse * g_lse).sum()).backward()
    delta = tfa._delta(o.detach(), w, g_lse)
    dq = tfa.flash_dq_plain(q, k, v, w, lse.detach(), delta, q_offset=8, k_offset=0)
    dk, dv = tfa.flash_dkv_plain(q, k, v, w, lse.detach(), delta, q_offset=8, k_offset=0)
    for got, ref in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_flash_attention_is_default_attention_on_the_cpu():
    q, k, v = (torch.from_numpy(x) for x in _arrays((2, 32, 4, 16), 3, 7))
    np.testing.assert_allclose(
        tfa.flash_attention(q, k, v).numpy(),
        default_attention(q, k, v).numpy(), rtol=2e-5, atol=2e-5,
    )


def test_merge_attention_matches_jax():
    """Two halves of a key range, each a block, merge into the whole
    (and JAX's merge gives the same); a fully masked partial is a no-op."""
    q, k, v = _arrays((1, 32, 2, 16), 3, 9)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o_a, l_a = tfa.flash_attention_block(tq, tk[:, :16], tv[:, :16], k_offset=0)
    o_b, l_b = tfa.flash_attention_block(tq, tk[:, 16:], tv[:, 16:], k_offset=16)
    o, lse = tfa.merge_attention(o_a, l_a, o_b, l_b)
    want_o, want_lse = jfa.merge_attention(
        *(jnp.asarray(x.numpy()) for x in (o_a, l_a, o_b, l_b))
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=3e-5, atol=3e-5)
    whole_o, whole_lse = tfa.reference_attention_with_lse(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), whole_o.numpy(), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), rtol=3e-5, atol=3e-5)
    o_f, l_f = tfa.flash_attention_block(tq, tk, tv, k_offset=64)  # all future
    o2, l2 = tfa.merge_attention(o, lse, o_f, l_f)
    np.testing.assert_allclose(o2.numpy(), o.numpy(), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(l2.numpy(), lse.numpy(), rtol=3e-5, atol=3e-5)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """The checks run before any launch, so they hold without a GPU."""
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="one dtype"):
        tfa._check_kernel_inputs([("q", q), ("k", q.double())], [])
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 64, 2, 48)
        tfa._check_kernel_inputs([("q", z)], [])
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_inputs([("q", q), ("k", q.transpose(1, 2))], [])
    with pytest.raises(ValueError, match="float32"):
        tfa._check_kernel_inputs([("q", q)], [("lse", torch.zeros(1, 2, 63))])
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        tfa.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"))


def test_kernels_take_the_fused_qkv_split_in_place():
    """The model's split thirds of its fused qkv projection reach the
    kernels as they are (rows 3 H D apart, no copy); a layout the kernels
    cannot read (heads not dense) is copied contiguous first."""
    qkv = torch.zeros(2, 64, 3 * 2 * 16)
    q, k, v = (x.reshape(2, 64, 2, 16) for x in qkv.split(32, dim=-1))
    tfa._check_kernel_inputs([("q", q), ("k", k), ("v", v)], [])
    views = tfa._kernel_views(q, k, v)
    assert [x.data_ptr() for x in views] == [x.data_ptr() for x in (q, k, v)]
    assert views[0].stride() == (64 * 96, 96, 16, 1)
    heads_first = torch.zeros(2, 2, 64, 16).transpose(1, 2)
    copied = tfa._kernel_views(heads_first, heads_first, heads_first)
    assert all(x.is_contiguous() for x in copied)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_inputs([("q", heads_first)], [])
    with pytest.raises(ValueError, match="dO must be contiguous"):
        tfa._check_kernel_inputs([("q", q), ("dO", q)], [])


def test_bf16_forward_ragged_tile_matches_jax():
    """A boundary of the tensor-core forward: bf16 inputs, T = 65 (one
    whole 64-row tile and one of a single row), causal, so the second
    tile's one row sees every key. JAX's
    reference (its CPU tests' path) and the port's plain forward agree
    within 2e-2 for o (one bf16 step, 1/64 for outputs in [2, 4), where
    sums in another order land on either side of a rounding boundary)
    and 1e-5 for the f32 lse."""
    q, k, v = _arrays((2, 65, 3, 16), 3, 11)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want_o, want_lse = jax.jit(
        lambda q, k, v: jfa.reference_attention_with_lse(q, k, v)
    )(bf(q), bf(k), bf(v))
    o, lse = tfa.flash_fwd_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(
        o.float().numpy(), np.asarray(want_o.astype(jnp.float32)), rtol=0, atol=2e-2
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)


def test_bf16_dkv_ragged_tile_matches_jax():
    """A boundary of the tensor-core dk/dv kernel: bf16 inputs, T = 65
    (one whole 64-key tile and a tile of a single key, which every query
    of the second query tile sees), causal. dk and dv of the kernel's
    plain version, fed by the plain forward's lse and delta, against
    ``jax.vjp`` of JAX's reference forward (its CPU tests' path) in
    bf16, within 2e-2: both round their outputs to bf16 and feed their
    last products bf16 operands, but autodiff reaches ds through the
    normalized softmax where the kernels take exp(s - lse) and delta, so
    sums in another order may land on either side of a rounding
    boundary: one bf16 step at the largest values here (1/64 in
    [2, 4))."""
    q, k, v, do = _arrays((2, 65, 3, 16), 4, 12)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda k, v: jfa.reference_attention_with_lse(bf(q), k, v)[0], bf(k), bf(v))
    want_dk, want_dv = vjp(bf(do))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv)
    dk, dv = tfa.flash_dkv_plain(tq, tk, tv, tdo, lse, tfa._delta(o, tdo, None))
    assert dk.dtype == dv.dtype == torch.bfloat16
    for got, want in ((dk, want_dk), (dv, want_dv)):
        ref = np.asarray(want.astype(jnp.float32))
        assert np.abs(ref).max() < 4
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("q_off", [0, 32])
def test_bf16_dq_ragged_tile_matches_jax(q_off):
    """A boundary of the tensor-core dq kernel: bf16 inputs, T = 65 (one
    whole 64-query tile and a tile of a single query, which sees every
    key tile), causal, and once with q_offset 32 (every query sees 32
    more keys). dq of the kernel's plain version, fed by the plain
    forward's lse and delta, against ``jax.vjp`` of JAX's reference
    forward (its CPU tests' path) in bf16, within 2e-2: both round dq to
    bf16 and feed the last product bf16 operands (ds rounded to k's
    dtype), but autodiff reaches ds through the normalized softmax where
    the kernels take exp(s - lse) and delta, so sums in another order may
    land on either side of a rounding boundary: one bf16 step at the
    largest values, at most 1/64 below 4 (the largest |dq| here is about
    1.6, where a step is 1/128)."""
    q, k, v, do = _arrays((2, 65, 3, 16), 4, 13 + q_off)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(
        lambda q: jfa.reference_attention_with_lse(q, bf(k), bf(v), q_offset=q_off)[0], bf(q)
    )
    want_dq, = vjp(bf(do))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, q_offset=q_off)
    dq = tfa.flash_dq_plain(tq, tk, tv, tdo, lse, tfa._delta(o, tdo, None), q_offset=q_off)
    assert dq.dtype == torch.bfloat16
    ref = np.asarray(want_dq.astype(jnp.float32))
    assert np.abs(ref).max() < 4
    np.testing.assert_allclose(dq.float().numpy(), ref, rtol=0, atol=2e-2)
