"""mpit_tpu_torch's int8 weight store and its matmuls against the JAX package's.

Inputs are made by numpy from a seed and handed to both packages.

- ``quantize_tensor`` payloads and scales are bit-identical to JAX's
  (f32 and bf16 sources, all-zero rows): one rounding contract.
- The blocked plain matmul (the CUDA kernel's plain version) is held
  within 1e-5 of ``quantized_matmul_lax`` on a shape with no 128-multiple
  (several row-block sizes), and of the Pallas kernel in interpret mode
  at one 128-multiple shape; the transposed head form and the
  whole-dequant oracle within 1e-5 of JAX's. Both sides sum the same f32
  products in their own orders, so they are held to a tolerance, not to
  bit equality.
- The CUDA kernel's ``mma`` body, modelled in PyTorch: the three bf16
  pieces of every dequantized weight (JAX's own int8 bytes and scales)
  sum to it exactly, and the three-piece split contraction (per-slice
  f32 partials summed in slice order) is held to JAX's
  ``quantized_matmul_lax``.
- ``weight_wire_bytes`` equals JAX's; the dispatcher runs the plain
  version on the CPU and raises for any device that is neither CPU nor
  CUDA, and the kernel wrapper's checks reject what the kernel does not
  take (they run before any launch, so they are testable here).
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mpit_tpu.ops import quantized_matmul as jqm
from mpit_tpu_torch.ops import quantized_matmul as tqm

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(w_np):
    """The same f32 weight quantized by each package."""
    return jqm.quantize_tensor(jnp.asarray(w_np)), tqm.quantize_tensor(
        torch.from_numpy(w_np)
    )


def test_quantize_tensor_bit_identical_to_jax():
    w = _rand((70, 33), 0)
    w[5] = 0.0  # an all-zero row: scale 1.0, exact zeros back
    jw, tw = _both(w)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    assert tw.q.dtype == torch.int8 and tuple(tw.scale.shape) == (70, 1)
    assert tw.scale[5].item() == 1.0 and not tqm.dequantize_tensor(tw)[5].any()
    # A bf16 source: both packages quantize the same bf16 values.
    wb = w.astype(ml_dtypes.bfloat16)
    jb = jqm.quantize_tensor(jnp.asarray(wb))
    tb = tqm.quantize_tensor(torch.from_numpy(wb.astype(np.float32)).bfloat16())
    np.testing.assert_array_equal(tb.q.numpy(), np.asarray(jb.q))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))


def test_quantized_tensor_container():
    _, tw = _both(_rand((6, 5), 1))
    assert tw.shape == (6, 5) and tw.dtype == torch.int8 and tw.ndim == 2
    rows = tw[torch.tensor([[4, 0]])]
    assert tuple(rows.q.shape) == (1, 2, 5) and tuple(rows.scale.shape) == (1, 2, 1)
    np.testing.assert_array_equal(rows.q[0, 0].numpy(), tw.q[4].numpy())


@pytest.mark.parametrize("block_rows", [16, 64, None])
def test_plain_blocked_matches_jax_lax(block_rows):
    """D = 70, F = 33: no 128-multiple, a ragged last row-block."""
    jw, tw = _both(_rand((70, 33), 2))
    x = _rand((3, 4, 70), 3)
    want = jqm.quantized_matmul_lax(jnp.asarray(x), jw, block_rows=block_rows)
    got = tqm.quantized_matmul_plain(torch.from_numpy(x), tw, block_rows=block_rows)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # The dispatcher takes the plain version for a CPU tensor.
    disp = tqm.quantized_matmul(torch.from_numpy(x), tw, block_rows=block_rows)
    assert torch.equal(disp, got)


def test_plain_blocked_matches_jax_kernel_interpret():
    """The Pallas kernel itself, in interpret mode, at a 128-multiple
    shape with two row-blocks."""
    jw, tw = _both(_rand((256, 128), 4))
    x = _rand((2, 256), 5)
    want = jqm.quantized_matmul(jnp.asarray(x), jw, block_rows=128, interpret=True)
    got = tqm.quantized_matmul_plain(torch.from_numpy(x), tw, block_rows=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_bf16_x_matches_jax():
    jw, tw = _both(_rand((48, 20), 6))
    x = _rand((5, 48), 7).astype(ml_dtypes.bfloat16)
    want = jqm.quantized_matmul_lax(jnp.asarray(x), jw, block_rows=16)
    got = tqm.quantized_matmul_plain(
        torch.from_numpy(x.astype(np.float32)).bfloat16(), tw, block_rows=16
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("block_rows", [16, None])
def test_transposed_and_reference_forms_match_jax(block_rows):
    x = _rand((2, 3, 70), 8)
    jh, th = _both(_rand((33, 70), 9))  # a [V, D] head
    want = jqm.quantized_matmul_t(jnp.asarray(x), jh, block_rows=block_rows)
    got = tqm.quantized_matmul_t(torch.from_numpy(x), th, block_rows=block_rows)
    assert got.shape == (2, 3, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    jw, tw = _both(_rand((70, 33), 10))
    want = jqm.quantized_matmul_reference(jnp.asarray(x), jw)
    got = tqm.quantized_matmul_reference(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize(
    "shape,tdt,jdt",
    [
        ((768, 2304), "int8", "int8"),
        ((50257, 768), torch.int8, jnp.int8),
        ((3072, 768), torch.float32, jnp.float32),
        ((768,), torch.bfloat16, jnp.bfloat16),
        ((4, 6, 10), "int8", "int8"),
    ],
)
def test_weight_wire_bytes_matches_jax(shape, tdt, jdt):
    assert tqm.weight_wire_bytes(shape, tdt) == jqm.weight_wire_bytes(shape, jdt)


def test_dispatcher_raises_off_cpu_and_cuda():
    _, tw = _both(_rand((8, 4), 11))
    with pytest.raises(ValueError, match="no quantized-matmul kernel"):
        tqm.quantized_matmul(torch.zeros(2, 8, device="meta"), tw)


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    _, tw = _both(_rand((8, 4), 12))
    x = torch.zeros(2, 8)
    tqm._check_kernel_inputs(x, tw)  # accepted
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tqm._check_kernel_inputs(x.half(), tw)
    with pytest.raises(ValueError, match="features"):
        tqm._check_kernel_inputs(torch.zeros(2, 7), tw)
    with pytest.raises(ValueError, match="contiguous"):
        tqm._check_kernel_inputs(torch.zeros(8, 2).T, tw)
    with pytest.raises(ValueError, match="scale"):
        tqm._check_kernel_inputs(x, tqm.QuantizedTensor(tw.q, tw.scale[:, 0]))
    with pytest.raises(ValueError, match="int8"):
        tqm._check_kernel_inputs(x, tqm.QuantizedTensor(tw.q.float(), tw.scale))
    with pytest.raises(ValueError, match="empty"):
        tqm._check_kernel_inputs(torch.zeros(0, 8), tw)


def _split3(w):
    """A PyTorch model of the kernel's ``attn_mma::split3`` on f32 ``w``:
    ``hi = bf16(w)``, ``mid = bf16(w - hi)``, ``lo = bf16(w - hi - mid)``;
    ``.to(torch.bfloat16)`` rounds to nearest even, as
    ``__floats2bfloat162_rn`` does. Returns the pieces as f32."""
    hi = w.to(torch.bfloat16).float()
    r = w - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _dequantized_by_jax(w_np):
    """JAX's int8 bytes and scales, dequantized as the kernel does: the
    one f32 product ``f32(q) * s``."""
    jw = jqm.quantize_tensor(jnp.asarray(w_np))
    q = torch.from_numpy(np.asarray(jw.q))
    scale = torch.from_numpy(np.asarray(jw.scale))
    return jw, q, scale, q.float() * scale


def test_split3_of_dequantized_weights_is_exact():
    """Each dequantized weight has at most 24 significant bits; the three
    round-to-nearest bf16 pieces take 8 each and both subtractions are
    exact in f32, so ``hi + mid + lo == w`` with no rounding at all, for
    rows whose scales run from 1e-30 to 1e30 and for an all-zero row."""
    rows = 61
    mags = 10.0 ** np.linspace(-30, 30, rows)
    w_np = (_rand((rows, 96), 13) * mags[:, None]).astype(np.float32)
    w_np[17] = 0.0
    jw, _, scale, w = _dequantized_by_jax(w_np)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jqm.dequantize_tensor(jw)))
    assert scale.min().item() < 1e-31 and scale.max().item() > 1e28
    hi, mid, lo = _split3(w)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, w.double())
    assert not (hi[17].any() or mid[17].any() or lo[17].any())
    # Every piece is a bf16 value, and mid and lo carry real bits.
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)
    assert mid.abs().sum() > 0 and lo.abs().sum() > 0


def _mma_model(x, q, scale, splits: int, bk: int = 32):
    """The ``mma`` body's arithmetic: bf16 x against the three pieces of
    each dequantized weight, 16 contraction rows a step into one f32
    accumulator, the contraction's BK-row tiles cut into ``splits``
    slices whose f32 partials are summed in slice order."""
    w = q.float() * scale
    pieces = _split3(w)
    d = w.shape[0]
    xf = x.float()
    tiles = np.array_split(np.arange(-(-d // bk)), splits)
    out = None
    for part in tiles:
        acc = torch.zeros((x.shape[0], w.shape[1]))
        for k0 in range(part[0] * bk, min(d, (part[-1] + 1) * bk), 16):
            sl = slice(k0, min(d, k0 + 16))
            for piece in pieces:
                acc = acc + xf[:, sl] @ piece[sl]
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("d,f", [(96, 130), (100, 256)])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_three_piece_split_contraction_matches_jax(m, d, f, splits):
    """The model of the ``mma`` body against JAX's ``quantized_matmul_lax``
    on the same bf16 x and int8 weight, within 1e-4 x max(1, max |jax|):
    the dequantized weights are equal bit for bit and every x * piece
    product is exact in f32, so the two differ only in the order of
    their f32 sums (a few ulps over D terms)."""
    jw, q, scale, _ = _dequantized_by_jax(_rand((d, f), 14))
    x = _rand((m, d), 15).astype(ml_dtypes.bfloat16)
    want = np.asarray(jqm.quantized_matmul_lax(jnp.asarray(x), jw))
    got = _mma_model(torch.from_numpy(x.astype(np.float32)).bfloat16(), q, scale, splits)
    assert got.shape == (m, f)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_split_scratch_counters_zeroed_and_workspace_grows():
    """The split contraction's per-device scratch: counters zeroed once,
    the workspace kept between calls and grown only when a call needs
    more (a CPU device stands in; the kernel reads both on the card)."""
    s = tqm._SplitScratch(torch.device("cpu"))
    assert s.counters.dtype == torch.int32 and not s.counters.any()
    first = s.take(100)
    assert first.numel() >= 100 and first.dtype == torch.float32
    assert s.take(60) is first
    grown = s.take(1000)
    assert grown.numel() >= 1000 and s.take(1000) is grown
