"""Flash attention: fused blockwise causal attention for training.

The port of :mod:`mpit_tpu.ops.flash_attention`. Public tensors are
``[B, T, H, D]`` (the model's sequence-major, head-split layout);
``lse`` is ``[B, H, T]`` f32.

- :func:`flash_attention` — drop-in for
  :func:`mpit_tpu_torch.models.gpt2.default_attention` (plug in as
  ``GPT2Config.attention_fn``);
- :func:`flash_attention_block` — one attention block of a longer
  sequence, placed by ``q_offset``/``k_offset``, returning ``(o,
  lse)``: a key block wholly in the queries' future gives ``o = 0`` and
  ``lse = -1e30``, the neutral element of :func:`merge_attention`;
- :func:`merge_attention` — the exact online-softmax merge of two
  partial results (plain PyTorch).

Both outputs are differentiable through one ``torch.autograd.Function``
with the Flash-2 backward: the forward saves ``o`` and ``lse`` only, the
backward recomputes the scores blockwise in two kernels (dq; dk/dv) from
``delta = rowsum(f32(dO) f32(O)) - g_lse`` — the lse cotangent folds
into delta, since ``d lse / d s = p``.

On the card the three steps launch the hand-written kernels of
``csrc/flash_attention.cu`` (every bf16 kernel on the tensor cores, the
``mma`` body; every f32 kernel on f32 FMAs, the ``fma`` body); on the
CPU they run their plain versions
(:func:`flash_fwd_plain` = :func:`reference_attention_with_lse`,
:func:`flash_dq_plain`, :func:`flash_dkv_plain`), which compute the same
function densely with the same rounding points. A CUDA tensor goes to
the kernel or raises — there is no fallback.

Numerics kept from the JAX package: scores are ``f32(q . k) * scale``
(the scale folds into the f32 scores, not into q); masked scores are
``-1e30``, not ``-inf``; ``p`` is rounded to v's dtype before the PV
product; ``ds`` to k's dtype before ``ds . k``, ``p`` to dO's dtype for
dv and ``ds`` to q's dtype for dk; dq and dk are multiplied by the scale
at the end; a row that sees no key gives ``o = 0`` and ``lse = -1e30``,
and in the backward ``p = 0`` wherever ``lse <= -5e29``.

Not ported: the TPU VMEM head-group planner (``_pick_head_group``,
``_group_resident``, ``usable_head_groups``) and ``interpret``: the
CUDA kernels take one head per block and have no interpret mode.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from mpit_tpu_torch.ops.build import load

__all__ = [
    "flash_attention",
    "flash_attention_block",
    "flash_dkv_plain",
    "flash_dq_plain",
    "flash_fwd_plain",
    "launches",
    "merge_attention",
    "path_launches",
    "reference_attention",
    "reference_attention_with_lse",
    "shape_launches",
]

_NEG_BIG = -1e30  # large-but-finite: -inf breaks the exp-shift of an empty row
_KERNEL_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)

# Launches of each CUDA kernel since the counts were last set to 0; a
# wrapper adds one where it launches, and nowhere else.
launches = {"fwd": 0, "dq": 0, "dkv": 0}
_C_KINDS = ("fwd", "dq", "dkv")  # the C library's kind codes, in order
_C_PATHS = ("fma", "mma")  # mpit_flash_path's answers, in order
# The same launches by body, keyed "<kind>/<body>": counted by the body the
# C library names for the launch (``mpit_flash_path``).
path_launches = {f"{kind}/{body}": 0 for kind in launches for body in _C_PATHS}
# The same launches by geometry, keyed ``(kind, B, T, H, q_offset,
# k_offset)`` from the launch's own arguments: a ring step's launches
# apart from the next step's, a head shard's from the whole model's.
# Set to 0 with ``shape_launches.clear()``.
shape_launches: collections.Counter = collections.Counter()


def _path(dtype) -> str:
    """The body a kernel launches for inputs of ``dtype``: ``mma`` (the
    tensor cores) for bf16, ``fma`` (f32 FMAs) for f32, for the forward,
    dq and dk/dv alike; the host's statement of the C library's rule,
    checked against ``mpit_flash_path`` at every launch."""
    return "mma" if dtype == torch.bfloat16 else "fma"


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' yardstick on the card.
# ---------------------------------------------------------------------------


def reference_attention(q, k, v, *, causal: bool = True):
    """Plain attention, ``[B, T, H, D]``; the parity oracle."""
    o, _ = reference_attention_with_lse(q, k, v, causal=causal)
    return o


def _visible(tq: int, tk: int, q_offset: int, k_offset: int, device):
    q_pos = q_offset + torch.arange(tq, device=device)
    k_pos = k_offset + torch.arange(tk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def reference_attention_with_lse(q, k, v, *, q_offset=0, k_offset=0, causal=True):
    """Attention block returning ``(o [B, T, H, D], lse [B, H, T])``.

    Offset-aware causal masking; fully masked rows yield ``o = 0`` and
    ``lse = -1e30`` (the merge-neutral element). Scores are the f32
    products of the operands over ``sqrt(D)``, as JAX's
    ``preferred_element_type=f32`` einsum computes them; the PV product
    runs in q's dtype."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if causal:
        vis = _visible(s.shape[-2], s.shape[-1], q_offset, k_offset, q.device)
        s = torch.where(vis, s, _NEG_BIG)
    m = s.amax(dim=-1)
    empty = m <= _NEG_BIG / 2
    p = torch.where(empty[..., None], 0.0, torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / l_safe[..., None]).to(q.dtype), v)
    lse = torch.where(empty, _NEG_BIG, m + torch.log(l_safe))
    o = torch.where(empty.transpose(1, 2)[..., None], 0.0, o).to(q.dtype)
    return o, lse


def flash_fwd_plain(q, k, v, *, q_offset=0, k_offset=0, causal=True):
    """The forward kernel's plain version: :func:`reference_attention_with_lse`."""
    return reference_attention_with_lse(
        q, k, v, q_offset=q_offset, k_offset=k_offset, causal=causal
    )


def _probs_from_lse(q, k, lse, q_offset, k_offset, causal):
    """``p = exp(s - lse)`` ``[B, H, Tq, Tk]`` f32 with the kernels'
    scores (``f32(q . k) * scale``, masked to -1e30) and the empty-row
    guard (``p = 0`` where ``lse <= -5e29``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        vis = _visible(s.shape[-2], s.shape[-1], q_offset, k_offset, q.device)
        s = torch.where(vis, s, _NEG_BIG)
    return torch.where(
        (lse <= _NEG_BIG / 2)[..., None], 0.0, torch.exp(s - lse[..., None])
    )


def _ds(q, k, v, do, lse, delta, q_offset, k_offset, causal):
    p = _probs_from_lse(q, k, lse, q_offset, k_offset, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, *, q_offset=0, k_offset=0, causal=True):
    """The dq kernel's plain version: ``dq = scale · Σ_k round_k(ds) k``
    with ``ds = p (f32(dO . v) - delta)``, in f32, cast to q's dtype."""
    _, ds = _ds(q, k, v, do, lse, delta, q_offset, k_offset, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, q_offset=0, k_offset=0, causal=True):
    """The dk/dv kernel's plain version: ``dv = Σ_q round_dO(p)ᵀ dO``,
    ``dk = scale · Σ_q round_q(ds)ᵀ q``, in f32, cast to k's and v's
    dtypes."""
    p, ds = _ds(q, k, v, do, lse, delta, q_offset, k_offset, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * (1.0 / math.sqrt(q.shape[-1]))).to(k.dtype), dv.to(v.dtype)


def _delta(o, do, g_lse):
    """Flash-2 ``delta = rowsum(f32(dO) f32(O))`` ``[B, H, T]``, minus the
    lse cotangent when there is one."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse
    return delta.contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The flash-attention kernels' library, built from its source at the
    first call (needs ``nvcc``) and loaded."""
    lib = load(_KERNEL_SOURCE)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # b t h d qoff koff causal, q/k/v batch and row strides, scale dtype stream
    geo = [i32] * 7 + [i64, i64, f32, i32, ptr]
    lib.mpit_flash_fwd.argtypes = [ptr] * 5 + geo
    lib.mpit_flash_dq.argtypes = [ptr] * 7 + geo
    lib.mpit_flash_dkv.argtypes = [ptr] * 8 + geo
    for fn in (lib.mpit_flash_fwd, lib.mpit_flash_dq, lib.mpit_flash_dkv):
        fn.restype = i32
    lib.mpit_flash_path.argtypes = [i32, i32]
    lib.mpit_flash_path.restype = i32
    lib.mpit_flash_error_string.argtypes = [i32]
    lib.mpit_flash_error_string.restype = ctypes.c_char_p
    return lib


def _readable_in_place(x, like) -> bool:
    """Whether the kernels read ``x`` (q, k or v) where it lies: each
    head's row dense, at ``like``'s batch and row strides, every row on a
    16-byte boundary (the split thirds of a fused qkv projection are)."""
    vec = 16 // x.element_size()
    return (
        x.stride() == like.stride()
        and x.stride(3) == 1
        and x.stride(2) == x.shape[3]
        and x.stride(0) % vec == 0
        and x.stride(1) % vec == 0
        and x.data_ptr() % 16 == 0
    )


def _check_kernel_inputs(tensors, rows):
    """Raise ValueError for anything the kernels do not take. ``tensors``:
    ``(name, [B, T, H, D] tensor)`` of one dtype, q first; q, k and v may
    be strided views (:func:`_readable_in_place`), the others must be
    contiguous; ``rows``: ``(name, [B, H, T] f32 tensor)``."""
    (_, q), *_ = tensors
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got {tuple(q.shape)}")
    b, t, h, d = q.shape
    for name, x in tensors + rows:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if name in ("q", "k", "v"):
            if not _readable_in_place(x, q):
                raise ValueError(
                    f"{name} must be contiguous in its last two dims, at q's strides, "
                    "with 16-byte aligned rows"
                )
        elif not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in tensors:
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}: one dtype for all")
        if tuple(x.shape) != (b, t, h, d):
            raise ValueError(f"{name} is {tuple(x.shape)}, q is {tuple(q.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, x in rows:
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, t):
            raise ValueError(f"{name} must be float32 {(b, h, t)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_KERNEL_HEAD_DIMS}")
    if not (1 <= b <= 65535 and 1 <= h <= 65535 and t >= 1):
        raise ValueError(f"unsupported geometry B={b}, T={t}, H={h}")


def _run(kind: str, fn, ptrs, q, q_offset, k_offset, causal):
    b, t, h, d = q.shape
    lib = kernel_library()
    path = _C_PATHS[lib.mpit_flash_path(_C_KINDS.index(kind), _DTYPES[q.dtype])]
    if path != _path(q.dtype):
        raise RuntimeError(
            f"the {kind} kernel would run the {path} body where _path says {_path(q.dtype)}"
        )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *ptrs, b, t, h, d, int(q_offset), int(k_offset), int(bool(causal)),
            q.stride(0), q.stride(1), 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream,
        )
    if err:
        msg = (
            lib.mpit_flash_error_string(err).decode()
            if err > 0
            else "unsupported dtype or head dim"
        )
        raise RuntimeError(f"flash-attention {kind} kernel launch failed ({err}): {msg}")
    launches[kind] += 1
    path_launches[f"{kind}/{path}"] += 1
    shape_launches[(kind, b, t, h, int(q_offset), int(k_offset))] += 1


def _fwd_kernel(q, k, v, q_offset, k_offset, causal):
    _check_kernel_inputs([("q", q), ("k", k), ("v", v)], [])
    b, t, h, _ = q.shape
    o = torch.empty((b, t, h, q.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    _run("fwd", kernel_library().mpit_flash_fwd, ptrs, q, q_offset, k_offset, causal)
    return o, lse


def _dq_kernel(q, k, v, do, lse, delta, q_offset, k_offset, causal):
    _check_kernel_inputs(
        [("q", q), ("k", k), ("v", v), ("dO", do)], [("lse", lse), ("delta", delta)]
    )
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ptrs = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
    )
    _run("dq", kernel_library().mpit_flash_dq, ptrs, q, q_offset, k_offset, causal)
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, q_offset, k_offset, causal):
    _check_kernel_inputs(
        [("q", q), ("k", k), ("v", v), ("dO", do)], [("lse", lse), ("delta", delta)]
    )
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2))
    ptrs = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
    )
    _run("dkv", kernel_library().mpit_flash_dkv, ptrs, q, q_offset, k_offset, causal)
    return dk, dv


def _device_kind(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {x.device}")
    return x.device.type


def flash_fwd(q, k, v, q_offset=0, k_offset=0, causal=True):
    """Forward step ``(o, lse)``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if _device_kind(q) == "cuda":
        return _fwd_kernel(q, k, v, q_offset, k_offset, causal)
    return flash_fwd_plain(q, k, v, q_offset=q_offset, k_offset=k_offset, causal=causal)


def flash_dq(q, k, v, do, lse, delta, q_offset=0, k_offset=0, causal=True):
    """dq step: the kernel for CUDA tensors, the plain version for CPU ones."""
    if _device_kind(q) == "cuda":
        return _dq_kernel(q, k, v, do, lse, delta, q_offset, k_offset, causal)
    return flash_dq_plain(
        q, k, v, do, lse, delta, q_offset=q_offset, k_offset=k_offset, causal=causal
    )


def flash_dkv(q, k, v, do, lse, delta, q_offset=0, k_offset=0, causal=True):
    """dk/dv step: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    if _device_kind(q) == "cuda":
        return _dkv_kernel(q, k, v, do, lse, delta, q_offset, k_offset, causal)
    return flash_dkv_plain(
        q, k, v, do, lse, delta, q_offset=q_offset, k_offset=k_offset, causal=causal
    )


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of one attention block, both differentiable.

    Gradients of outputs that were never formed arrive as ``None``
    (``set_materialize_grads(False)``) and count as zero: JAX always
    hands its backward a dense zero ``g_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal):
        o, lse = flash_fwd(q, k, v, q_offset, k_offset, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.geometry = (q_offset, k_offset, causal)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        g_o = g_o.to(o.dtype).contiguous()
        delta = _delta(o, g_o, g_lse)
        geo = ctx.geometry
        dq = flash_dq(q, k, v, g_o, lse, delta, *geo)
        dk, dv = flash_dkv(q, k, v, g_o, lse, delta, *geo)
        return dq, dk, dv, None, None, None


def _kernel_views(q, k, v):
    """q, k and v as the kernels take them: as they are when the kernels
    read them in place (the model's split views of its fused qkv
    projection), else contiguous copies."""
    if all(_readable_in_place(x, q) for x in (q, k, v)):
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _pick_block(t: int, want: int | None) -> int:
    """JAX's block choice: an explicit ``want`` clamped to T, else
    ``min(512, T)`` halved while above 128 and not dividing T."""
    if want is not None:
        return min(want, t)
    b = min(512, t)
    while b > 128 and t % b:
        b //= 2
    return b


def flash_attention_block(
    q,
    k,
    v,
    *,
    q_offset: int = 0,
    k_offset: int = 0,
    causal: bool = True,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """One attention block of a longer sequence: ``(o, lse)``.

    ``q_offset``/``k_offset`` place this ``[B, Tq, H, D]`` query block and
    ``[B, Tk, H, D]`` key/value block in the global sequence for causal
    masking. Key blocks wholly in the future give ``o = 0`` and ``lse =
    -1e30``. Differentiable in q, k, v through both outputs.

    ``block_q``/``block_k`` are JAX's tiling arguments: on the card T
    must equal for q and k and be divisible by both (as the JAX kernel
    requires), while the CUDA kernels pick their own tile. CPU tensors
    run the plain versions, which take any shapes (JAX's off-TPU path).
    """
    tq, tk = q.shape[1], k.shape[1]
    block_q, block_k = _pick_block(tq, block_q), _pick_block(tk, block_k)
    if q.device.type == "cuda":
        if tq % block_q or tk % block_k:
            raise ValueError(
                f"seq lens ({tq}, {tk}) must be divisible by blocks "
                f"({block_q}, {block_k})"
            )
        if tq != tk:
            raise ValueError(f"block kernel requires Tq == Tk; got {tq} vs {tk}")
    return _FlashAttention.apply(
        *_kernel_views(q, k, v), int(q_offset), int(k_offset), bool(causal)
    )


def merge_attention(o_a, lse_a, o_b, lse_b):
    """Merge two attention partial results over disjoint key sets.

    ``o [B, T, H, D]`` (normalized within its key set), ``lse [B, H,
    T]``. Exact online-softmax combination; ``lse = -1e30`` partials
    (fully masked blocks) are absorbed as no-ops."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return (o_a * w_a + o_b * w_b).to(o_a.dtype), lse_new


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """Fused causal attention over ``[B, T, H, D]`` tensors: drop-in for
    :func:`mpit_tpu_torch.models.gpt2.default_attention`. On the card T
    must be a multiple of the block sizes (``block_q``/``block_k``,
    clamped to T; default JAX's choice)."""
    t = q.shape[1]
    block_q, block_k = _pick_block(t, block_q), _pick_block(t, block_k)
    if q.device.type == "cuda" and (t % block_q or t % block_k):
        raise ValueError(
            f"seq len {t} must be divisible by block_q={block_q}, block_k={block_k}"
        )
    o, _ = _FlashAttention.apply(*_kernel_views(q, k, v), 0, 0, bool(causal))
    return o
