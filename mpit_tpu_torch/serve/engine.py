"""Batched GPT-2 inference engine over a dense per-slot KV cache or a
paged pool.

The execution contract, as in :mod:`mpit_tpu.serve.engine`:

- **Prefill** (dense) writes each admitted request's padded prompt into
  its slot's cache from position 0 and samples the request's first
  output token from the output at ``prompt_len - 1``. The paged engine
  prefills in chunks instead (:meth:`Engine.prefill_paged`): each call
  feeds every prefilling slot one slice of its prompt, starting at the
  tokens it already holds (a shared prefix included), and a slot whose
  last prompt token rides the chunk samples its first token.
- **Decode** appends one token per active slot at its current length
  and samples the next.
- **Sampling** takes per-slot temperature / top-k arrays, so requests
  with different settings batch together.

``decode_attention="kernel"`` runs attention through the flash-decode
kernel (:func:`mpit_tpu_torch.ops.flash_decode_attention`, or
:func:`~mpit_tpu_torch.ops.flash_paged_decode_attention` on the paged
pool) and samples through the blocked LM head
(:func:`mpit_tpu_torch.ops.lm_head_sample`, no ``[slots, vocab]``
logits); ``"reference"`` runs the plain attention (over the gathered,
dequantized cache) and samples from materialized logits
(:func:`sample_tokens`), the parity oracle.

``kv_dtype`` picks the cache's storage: ``"f32"``, ``"bf16"``, or
``"int8"`` (int8 rows and per-(row, head) f32 scales, quantized on
write); ``None`` follows the model dtype. It may differ from the
activation dtype.

``spec_k=k`` (with ``draft_params`` / ``draft_cfg``) swaps the decode
tick for speculative draft-then-verify, as in the JAX package: the draft
model (its own cache: one a slot, or on the pool a draft pool that
mirrors the target's block tables and copy-on-write copies) proposes
``k`` tokens a slot (:meth:`Engine.spec_draft`), one target pass at T =
k + 1 verifies them (:meth:`Engine.spec_verify`: the kernel engine
samples through the blocked :func:`~mpit_tpu_torch.ops.lm_head.lm_head_verify`,
the reference engine through
:func:`~mpit_tpu_torch.serve.spec.verify_reference`), and the lengths
advance by the emitted count only (the rollback). The draft runs the
plain attention, as JAX's does: its proposal ``q`` is part of the
acceptance contract and its logits are small. Prefill fills the draft's
cache too; :meth:`Engine.decode` raises on a speculative engine.

``world=`` with ``tp_axis=`` serves tensor-parallel over that axis's
``p`` ranks, all on the engine's device (the JAX engine's
``world``/``tp_axis``): the model is :class:`~mpit_tpu_torch.serve.tp.TPGPT2`
(qkv/fc column-parallel, proj/out row-parallel, one rank-order sum a
half), the cache or pool is head-sharded (``[p, layers, ..., heads / p,
head_dim]``), and each rank's attention and int8 matmuls launch their
kernels on its own heads and weight shard. Lengths, the last tokens, the
block tables, the LM head and the sampler are replicated and run once,
and a speculative engine's draft is replicated (one model, one cache),
as in JAX. Under ``data × model`` the data replicas of a serving engine
compute the same thing (JAX replicates them over the data axis), so the
engine computes one replica: ``p`` is the ``tp_axis`` size.

``kv_host_pages=N`` (paged only) gives the pool a host KV tier: ``N``
page-sized seats in host memory (pinned on the card, allocated at
construction) where the scheduler parks a preemption victim's pages and
migrates prefix entries that would die with theirs.
:meth:`Engine.spill_page` first copies a page, whole (every layer, K and
V, an int8 pool's scales, every rank's head shard, the draft pool), into
a fresh device tensor on the current stream: stream order puts that copy
before any later write into the page, which the next prefill may make.
The device-to-host copy then runs on a side stream behind a CUDA event,
overlapping the next tick; :meth:`Engine.drain_spills` waits on the
events, and :meth:`Engine.restore_page` drains a seat still in flight
before it writes the seat back into a page.

``weights_dtype="int8"`` serves the int8 weight store: the state is
quantized on the CPU (:func:`~mpit_tpu_torch.serve.weights.quantize_gpt2_params`)
before it moves to the device, and the dense layers run the
fused-dequant matmul (:func:`mpit_tpu_torch.ops.quantized_matmul.quantized_matmul`,
the CUDA kernel on the card) — or, in a reference engine, the
whole-dequant oracle. ``None`` and ``"f32"`` serve the state as loaded.

Every engine keeps a byte-exact device-memory ledger (``memledger``,
:class:`~mpit_tpu_torch.obs.MemLedger`): its weight store, its cache
tensors, the draft and the per-slot state are granted once at
construction from the tensors' own sizes; the paged allocator grants and
frees pages (``kv_pages``) and copy-on-write reserves as they move, the
scheduler grants and frees the dense cache's slots (``kv_slots``), and
the host tier its seats (``kv_host_pages``). ``compile_watch`` records a
kernel-library build inside an engine call
(:class:`~mpit_tpu_torch.obs.roofline.CompileWatch`);
:meth:`Engine.register_roofline` registers each step's analytic cost with
the obs recorder and :meth:`Engine.decode_achieved_hbm_bytes` models a
decode tick's bytes from the tiles the length-aware kernel visits.

The cache is updated in place (JAX rebuilds it each step). Every call
runs the forward over all slots, as the JAX package's fixed shapes do:
the matmuls' row count is then the same whichever requests share a
prefill (cuBLAS is not row-invariant in the row count), so a request's
K/V rows and tokens do not depend on its neighbours — what lets a fleet
worker that prefills one request at a time reproduce the single
engine's rows. Dense prefill runs over a copy of every slot's buffers
and writes back the admitted slots only; paged prefill writes straight
into the shared pool, the rows of slots that take no part masked to the
trash page; decode runs all slots. Free slots decode at length 0: on
the dense cache their row 0 is junk that the next admission's prefill
overwrites, on the pool their writes go to the trash page.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpit_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mpit_tpu_torch.obs import roofline as _roofline
from mpit_tpu_torch.obs.memledger import MemLedger
from mpit_tpu_torch.ops.decode_attention import (
    flash_decode_attention,
    flash_paged_decode_attention,
    kernel_library,
    num_kv_blocks,
    pick_block_k,
)
from mpit_tpu_torch.ops.kv_quant import QuantizedKV, kv_tensors, kv_wire_bytes_per_row
from mpit_tpu_torch.ops.lm_head import gumbel, lm_head_sample, lm_head_verify
from mpit_tpu_torch.ops.quantized_matmul import (
    kernel_library as qmm_kernel_library,
    quantized_matmul,
    quantized_matmul_reference,
)
from mpit_tpu_torch.serve.kvcache import (
    PageAllocator,
    alloc_cache,
    alloc_paged_cache,
)
from mpit_tpu_torch.serve.tp import TPGPT2
from mpit_tpu_torch.serve.spec import (
    accept_emit,
    draft_distribution,
    modified_logits,
    register_draft_store,
    verify_reference,
)
from mpit_tpu_torch.serve.weights import (
    quantize_gpt2_params,
    register_param_store,
    shard_gpt2_params,
)
from mpit_tpu_torch.utils.profiling import gpt2_step_cost

__all__ = ["Engine", "modified_logits", "resolve_device", "sample_tokens"]

# "kernel" = flash-decode kernel + blocked head; "reference" = plain
# cached attention + dense sampling. The JAX package's "interpret"
# (the Pallas interpreter) has no counterpart here.
_DECODE_MODES = ("kernel", "reference")
_DTYPE_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Engine.kv_dtype values; None = follow the model dtype.
_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": None}
# Engine.weights_dtype values; None = the state as loaded (f32).
_WEIGHT_DTYPES = ("f32", "int8")


def _watched(phase: str):
    """Route an engine call through the engine's ``compile_watch``, under
    the span name the scheduler uses for it."""

    def deco(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            return self.compile_watch.call(phase, fn, self, *args, **kwargs)

        return call

    return deco


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable
    GPU raises: the port never carries on, on the CPU, unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def sample_tokens(logits, temperature, top_k, *, generator=None, noise=None):
    """Per-slot sampling over ``logits`` ``[S, V]`` f32:
    ``temperature <= 0`` is greedy (argmax), else a categorical draw from
    :func:`~mpit_tpu_torch.serve.spec.modified_logits` (the one the
    speculative draft shares) by the Gumbel-max trick. ``noise`` ``[S, V]``
    replaces the Gumbel draw from ``generator`` (tests feed both
    packages the same numbers). Returns ``[S]`` int32."""
    if noise is None:
        noise = gumbel(logits.shape, generator=generator, device=logits.device)
    scaled = modified_logits(logits, temperature, top_k) + noise.to(logits)
    greedy = temperature <= 0.0
    return torch.where(greedy, logits.argmax(-1), scaled.argmax(-1)).int()


class Engine:
    """Slot-batched KV-cache inference over one GPT-2 ``state_dict``
    (:func:`mpit_tpu_torch.serve.weights.params_from_jax` or
    :func:`~mpit_tpu_torch.serve.weights.load_gpt2_params`).

    Device state lives on the engine (cache + per-slot last token);
    ``active`` and the sampling arrays are passed per call by the
    scheduler. ``device`` defaults to ``"cuda"`` and raises without a
    GPU; the kernel is built at construction, so its compile is set-up
    time and not the first prefill's.

    ``kv_pages`` selects the paged engine: a pool of ``kv_pages`` pages
    of ``kv_page_size`` tokens shared by all slots, mapped by the host
    :class:`~mpit_tpu_torch.serve.kvcache.PageAllocator`; ``max_len``
    becomes each slot's virtual capacity (``pages_per_slot ×
    page_size``). ``prefill_chunk`` (paged only) is the prompt slice one
    prefill call feeds per slot. ``weights_dtype="int8"`` quantizes the
    matmul weights on the CPU and serves them through the fused-dequant
    matmul (its kernel library, too, is built at construction); a
    speculative engine's draft quantizes too and always runs the
    fused-dequant matmul, even on a reference engine (JAX:
    ``mpit_tpu/serve/engine.py:785-803``).

    ``spec_k`` > 0 makes the engine speculative (module docstring):
    ``draft_params`` is the draft's ``state_dict`` and ``draft_cfg`` its
    config (:func:`~mpit_tpu_torch.serve.weights.draft_from_target`), of
    the target's vocabulary, with positions covering ``max_len``.

    ``world`` (:func:`mpit_tpu_torch.comm.init`) with ``tp_axis`` makes
    the engine tensor-parallel over that axis (module docstring); the
    World's ranks must live on ``device``."""

    def __init__(
        self,
        cfg: GPT2Config,
        params,
        *,
        slots: int = 8,
        max_len: int | None = None,
        prefill_len: int | None = None,
        seed: int = 0,
        device="cuda",
        decode_attention: str = "kernel",
        sample_k_cap: int = 128,
        kv_pages: int | None = None,
        kv_page_size: int = 16,
        prefill_chunk: int | None = None,
        kv_dtype: str | None = None,
        weights_dtype: str | None = None,
        spec_k: int = 0,
        draft_params=None,
        draft_cfg: GPT2Config | None = None,
        world=None,
        tp_axis: str | None = None,
        kv_host_pages: int | None = None,
    ):
        if decode_attention not in _DECODE_MODES:
            raise ValueError(
                f"decode_attention must be one of {_DECODE_MODES}, got "
                f"{decode_attention!r}"
            )
        if kv_dtype is not None and kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {sorted(_KV_DTYPES)} (or None = "
                f"follow the model dtype), got {kv_dtype!r}"
            )
        if weights_dtype is not None and weights_dtype not in _WEIGHT_DTYPES:
            raise ValueError(
                f"weights_dtype must be one of {list(_WEIGHT_DTYPES)} (or "
                f"None = the state as loaded), got {weights_dtype!r}"
            )
        self.device = resolve_device(device)
        # "cuda" or "cpu": the label the roofline and the memory ledger
        # carry (percentages and device reconciliation only on the card).
        self.platform = self.device.type
        # What the process held on the card before this engine's tensors:
        # the memory ledger reconciles against the allocator less this.
        self.device_bytes_before = (
            torch.cuda.memory_allocated(self.device) if self.platform == "cuda" else 0
        )
        # Kernel-library builds inside engine calls; warm_engine pins the
        # expectation once the warm-up has run.
        self.compile_watch = _roofline.CompileWatch(scope="engine")
        self.roofline_costs: dict | None = None  # set by register_roofline
        self.tp_axis = tp_axis
        self.tp = 0  # the ranks of the tensor-parallel axis; 0: one rank
        if tp_axis is not None:
            if world is None:
                raise ValueError("tp_axis requires a World")
            self.tp = world.axis_size(tp_axis)
            if cfg.num_heads % self.tp:
                raise ValueError(f"num_heads ({cfg.num_heads}) must divide TP={self.tp}")
            here = self.device
            if here.type == "cuda" and here.index is None:  # the current card
                here = torch.device("cuda", torch.cuda.current_device())
            if world.device != here:
                raise ValueError(
                    f"the World's ranks live on {world.device}, the engine on {here}"
                )
        elif world is not None:
            raise ValueError("world without tp_axis: name the axis to serve tensor-parallel on")
        self.slots = slots
        self.max_len = min(max_len or cfg.max_seq_len, cfg.max_seq_len)
        self.spec_k = int(spec_k or 0)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k:
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "spec_k > 0 requires draft_params and draft_cfg (the draft "
                    "model proposing the k tokens the target verifies); a "
                    "layer-truncated self-draft comes from "
                    "serve.weights.draft_from_target"
                )
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_cfg.vocab_size} != target vocab_size "
                    f"{cfg.vocab_size}: speculation verifies draft proposals under "
                    "the target distribution, token for token"
                )
            if draft_cfg.max_seq_len < self.max_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} < engine max_len "
                    f"{self.max_len}: the draft's positional table must cover every "
                    "cache position it drafts at"
                )
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError(
                "draft_params/draft_cfg without spec_k: pass spec_k >= 1 to "
                "enable speculation"
            )
        self.prefill_len = min(prefill_len or self.max_len, self.max_len)
        self.kv_quantized = kv_dtype == "int8"
        # The label spans and stats carry: what a cached row is stored
        # as. Spans carry it only when it was chosen explicitly.
        self.kv_dtype_explicit = kv_dtype is not None
        self.kv_dtype = kv_dtype or _DTYPE_SHORT.get(cfg.dtype, str(cfg.dtype))

        self.paged = kv_pages is not None
        self.host_pages = int(kv_host_pages or 0)
        if self.host_pages < 0:
            raise ValueError(f"kv_host_pages must be >= 0, got {kv_host_pages}")
        if self.host_pages and not self.paged:
            raise ValueError(
                "kv_host_pages is the paged engine's host KV tier; the "
                "dense cache spills whole slots via export_kv_rows "
                "(pass kv_pages=)"
            )
        if self.paged:
            if kv_pages < 1:
                raise ValueError(f"kv_pages must be >= 1, got {kv_pages}")
            if kv_page_size < 1 or self.max_len % kv_page_size:
                raise ValueError(
                    f"kv_page_size {kv_page_size} must divide "
                    f"max_len={self.max_len} (pages_per_slot must be whole)"
                )
            self.page_size = kv_page_size
            self.num_pages = kv_pages
            self.pages_per_slot = self.max_len // kv_page_size
        elif prefill_chunk is not None:
            raise ValueError(
                "prefill_chunk is the paged engine's chunked-prefill knob; "
                "the dense cache prefills whole prompts (pass kv_pages=)"
            )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = min(prefill_chunk or self.prefill_len, self.prefill_len)

        # The kernel's cache-length tile (its default for this geometry):
        # the page size on the pool, max_len on the dense cache.
        self.decode_block_k = pick_block_k(
            self.page_size if self.paged else self.max_len
        )
        self.decode_attention = decode_attention
        self._blocked_head = decode_attention == "kernel"
        if self._blocked_head:
            field = "paged_attention_fn" if self.paged else "cache_attention_fn"
            fn = flash_paged_decode_attention if self.paged else flash_decode_attention
            cfg = dataclasses.replace(cfg, **{field: fn})
            if self.device.type == "cuda":
                kernel_library()
        self.cfg = cfg  # what the forward really runs, kernel included
        self.decode_sampler = "blocked" if self._blocked_head else "dense"
        # The blocked sampler bounds top_k by its candidate buffer; the
        # scheduler validates at submit. None = dense path, no bound.
        self.sample_k_cap = sample_k_cap if self._blocked_head else None
        # What the matmul weights are stored as; spans carry it only
        # when it was chosen explicitly.
        self.weights_quantized = weights_dtype == "int8"
        self.weights_dtype_explicit = weights_dtype is not None
        self.weights_dtype = weights_dtype or "f32"
        if self.weights_quantized:
            # Reference engines run the whole-dequant oracle; kernel
            # engines the fused-dequant matmul.
            qmm = (
                quantized_matmul_reference
                if decode_attention == "reference"
                else quantized_matmul
            )
            cfg = dataclasses.replace(
                cfg,
                quant_matmul_fn=functools.partial(
                    qmm, block_rows=cfg.quant_block_rows or None
                ),
            )
            self.cfg = cfg
            if self.device.type == "cuda" and qmm is quantized_matmul:
                qmm_kernel_library()
        if self.tp:
            # Repack, quantize whole, then cut (JAX's order), on the CPU.
            params = shard_gpt2_params(params, self.tp, quantize=self.weights_quantized)
            self.model = TPGPT2(cfg, self.tp, device=self.device,
                                quantized=self.weights_quantized)
        else:
            if self.weights_quantized:
                params = quantize_gpt2_params(params)  # on the CPU
            self.model = GPT2(cfg, device=self.device, quantized=self.weights_quantized)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        store = dict(
            device=self.device,
            dtype=None if kv_dtype is None else _KV_DTYPES[kv_dtype],
            quantized=self.kv_quantized,
        )
        tp_store = dict(store, ranks=self.tp)
        if self.paged:
            self.allocator = PageAllocator(
                self.num_pages, self.page_size, self.pages_per_slot, slots,
                host_pages=self.host_pages,
            )
            self.cache = alloc_paged_cache(
                cfg, slots, self.num_pages, self.page_size, **tp_store
            )
        else:
            self.allocator = None
            self.cache = alloc_cache(cfg, slots, self.max_len, **tp_store)
        self.draft_cfg = self.draft_model = self.draft_cache = None
        self._spec_state = None  # (drafted, q_x, q_probs) on the device
        if self.spec_k:
            self._build_draft(draft_params, draft_cfg, store)
        self.last_token = torch.zeros(
            (slots,), dtype=torch.int32, device=self.device
        )
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.host_pages:
            self._alloc_host_tier()
        # One cached K (or V) row of one layer at its storage width (int8
        # rows with their scales): the length-aware decode bytes' unit.
        self._kv_row_bytes = kv_wire_bytes_per_row(
            cfg.num_heads, cfg.head_dim,
            torch.int8 if self.kv_quantized else kv_tensors(self.cache.k)[0].dtype,
        )
        self._register_memory()

    def _register_memory(self) -> None:
        """The memory ledger's static grants, from the tensors' own sizes:
        the weight store (``weights``), the cache tensors and lengths
        (``kv_pool``), the draft (``draft_weights``, its cache on
        ``kv_pool``), the last tokens (``step_buffers``); and the nested
        capacities the allocator (``kv_pages``, ``kv_cow_reserve``), the
        scheduler (``kv_slots``) and the host tier (``kv_host_pages``)
        grant into."""
        ml = self.memledger = MemLedger(platform=self.platform)
        target = self.model.state_dict()
        self._param_bytes = register_param_store(ml, target)

        def nbytes(c) -> int:
            return sum(t.numel() * t.element_size() for t in kv_tensors(c.k) + kv_tensors(c.v))

        kv_buf = nbytes(self.cache)
        lengths_bytes = self.cache.lengths.numel() * self.cache.lengths.element_size()
        draft_kv = 0
        if self.draft_cache is not None:
            draft_kv = nbytes(self.draft_cache)
            d_len = self.draft_cache.lengths
            lengths_bytes += d_len.numel() * d_len.element_size()
        ml.register("kv_pool", capacity_bytes=kv_buf + draft_kv + lengths_bytes)
        ml.grant("kv_pool", kv_buf + lengths_bytes, kind="cache_buffers")
        if self.spec_k:
            register_draft_store(
                ml, self.draft_model.state_dict(), target_params=target, kv_bytes=draft_kv
            )
        ml.grant("step_buffers", self.last_token.numel() * self.last_token.element_size(),
                 kind="last_token")
        self.slot_bytes = 0
        if self.paged:
            # page_bytes spans every tensor a page spans, the draft pool's
            # too; the pool's trash page is in kv_pool, not in kv_pages.
            ml.register("kv_pages", capacity_bytes=self.num_pages * self.page_bytes,
                        nested_in="kv_pool")
            ml.register("kv_cow_reserve", nested_in="kv_pool")
            self.allocator.memledger = ml
            self.allocator.page_bytes = self.page_bytes
            if self.host_pages:
                ml.register("kv_host_pages", capacity_bytes=self.host_pages * self.page_bytes,
                            nested_in="host_ram")
        else:
            self.slot_bytes = (kv_buf + draft_kv) // self.slots
            ml.register("kv_slots", capacity_bytes=self.slots * self.slot_bytes,
                        nested_in="kv_pool")

    def _build_draft(self, params, cfg: GPT2Config, store: dict) -> None:
        """The draft model and its cache. The draft runs the plain
        attention and materializes its logits, as JAX's does: its
        proposal ``q`` is part of the acceptance contract (this is the
        JAX design, not a fallback from the kernel). Under int8 weights
        it quantizes too and always runs the fused-dequant matmul. Its
        cache mirrors the target's: one a slot, or a pool of the same
        page geometry and K/V storage under the same block tables. On a
        tensor-parallel engine it is replicated: one whole model and
        cache, run once."""
        cfg = dataclasses.replace(cfg, cache_attention_fn=None, paged_attention_fn=None)
        if self.weights_quantized:
            cfg = dataclasses.replace(
                cfg,
                quant_matmul_fn=functools.partial(
                    quantized_matmul, block_rows=cfg.quant_block_rows or None
                ),
            )
            params = quantize_gpt2_params(params)  # on the CPU
            if self.device.type == "cuda":
                qmm_kernel_library()
        self.draft_cfg = cfg
        self.draft_model = GPT2(cfg, device=self.device, quantized=self.weights_quantized)
        self.draft_model.load_state_dict(params)
        self.draft_model.requires_grad_(False)
        if self.paged:
            self.draft_cache = alloc_paged_cache(
                cfg, self.slots, self.num_pages, self.page_size, **store
            )
        else:
            self.draft_cache = alloc_cache(cfg, self.slots, self.max_len, **store)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _block_tables(self) -> torch.Tensor:
        """The allocator's block tables, uploaded as int32. Every entry
        must name a page of the pool: the kernel reads the pages its
        table names without a bounds check."""
        bt = self.allocator.block_tables
        if bt.min() < 0 or bt.max() >= self.num_pages:
            raise RuntimeError(
                f"block table names pages outside [0, {self.num_pages})"
            )
        return torch.tensor(bt, dtype=torch.int32, device=self.device)

    def _sample_last(self, out, gather_idx, temp, topk):
        """Token per row from the forward's output at ``gather_idx``:
        the hidden row streamed through the blocked head, or the logits
        row sampled densely."""
        row = out[torch.arange(out.shape[0], device=self.device), gather_idx]
        if not self._blocked_head:
            return sample_tokens(row.float(), temp, topk, generator=self._gen)
        return lm_head_sample(
            row,
            self.model.head_weight(),
            temp,
            topk,
            generator=self._gen,
            k_cap=self.sample_k_cap,
            compute_dtype=self.cfg.head_dtype,
        )

    @_watched("prefill")
    @torch.no_grad()
    def prefill(self, tokens, prompt_lens, admit, temp, topk) -> np.ndarray:
        """Admit requests: ``tokens`` ``[slots, prefill_len]`` (padded),
        ``prompt_lens``/``admit``/``temp``/``topk`` ``[slots]``. Returns
        the per-slot last token (the first OUTPUT token for admitted
        slots) as host numpy; the fetch is the step's completion fence."""
        if self.paged:
            raise ValueError(
                "the paged engine prefills through prefill_paged (block-"
                "table writes + chunking); the dense prefill has no pages"
            )
        admit = np.asarray(admit, bool)
        if admit.any():
            idx = self._tensor(np.flatnonzero(admit), torch.long)
            every = torch.arange(self.slots, device=self.device)
            plen = self._tensor(prompt_lens, torch.int32)
            c = self.cache
            k, v = c.k[c.at(every)], c.v[c.at(every)]  # copies; admitted written back
            fresh = torch.zeros_like(plen)
            out, _ = self.model(
                self._tensor(tokens, torch.long), cache=(k, v, fresh),
                return_hidden=self._blocked_head,
            )
            tok = self._sample_last(
                out,
                (plen.long() - 1).clamp_min(0),
                self._tensor(temp, torch.float32),
                self._tensor(topk, torch.int32),
            )
            c.k[c.at(idx)] = k[c.at(idx)]
            c.v[c.at(idx)] = v[c.at(idx)]
            c.lengths[idx] = plen[idx]
            self.last_token[idx] = tok[idx]
            if self.spec_k:
                # The draft's prefill rides along: the same tokens into
                # its own cache, no sampling (JAX fuses it into the step).
                d = self.draft_cache
                dk, dv = d.k[:, every], d.v[:, every]
                self.draft_model(
                    self._tensor(tokens, torch.long), cache=(dk, dv, fresh),
                    return_hidden=True,
                )
                d.k[:, idx] = dk[:, idx]
                d.v[:, idx] = dv[:, idx]
        return self.last_token.cpu().numpy()

    @_watched("prefill")
    @torch.no_grad()
    def prefill_paged(
        self, tokens, base, chunk_lens, floor, sample_mask, temp, topk
    ) -> np.ndarray:
        """One prefill chunk (paged engine): ``tokens`` ``[slots,
        prefill_chunk]`` holds each slot's prompt slice starting at
        position ``base``, ``chunk_lens`` tokens of it (0 = the slot
        takes no part). Rows below ``floor`` (shared pages are
        immutable; their values would be identical anyway) and padding
        rows are not written. Slots with ``sample_mask`` set sample
        their first output token from the chunk's last row. Block tables
        come from the allocator. Returns the per-slot last token as host
        numpy."""
        if not self.paged:
            raise ValueError("prefill_paged requires Engine(kv_pages=...)")
        chunk_lens = np.asarray(chunk_lens, np.int32)
        part = np.flatnonzero(chunk_lens > 0)
        if part.size:
            base = np.asarray(base, np.int32)
            t_idx = np.arange(np.asarray(tokens).shape[1])[None, :]
            # A slot that takes no part has chunk length 0: none of its
            # rows is written.
            write_valid = (t_idx < chunk_lens[:, None]) & (
                base[:, None] + t_idx >= np.asarray(floor)[:, None]
            )
            idx = self._tensor(part, torch.long)
            lens = self._tensor(base, torch.int32)
            c = self.cache
            out, _ = self.model(
                self._tensor(tokens, torch.long),
                paged_cache=(
                    c.k, c.v, lens, self._block_tables(),
                    self._tensor(write_valid, torch.bool),
                ),
                return_hidden=self._blocked_head,
            )
            tok = self._sample_last(
                out,
                self._tensor(np.maximum(chunk_lens - 1, 0), torch.long),
                self._tensor(temp, torch.float32),
                self._tensor(topk, torch.int32),
            )
            c.lengths[idx] = lens[idx] + self._tensor(chunk_lens[part], torch.int32)
            if self.spec_k:
                # The draft's chunk: the same slices and write mask (the
                # floor included: shared pages already hold the draft
                # K/V of the slot that registered the prefix), through
                # the same block tables into the draft pool.
                d = self.draft_cache
                self.draft_model(
                    self._tensor(tokens, torch.long),
                    paged_cache=(
                        d.k, d.v, lens, self._block_tables(),
                        self._tensor(write_valid, torch.bool),
                    ),
                    return_hidden=True,
                )
            keep = np.flatnonzero(np.asarray(sample_mask, bool) & (chunk_lens > 0))
            keep = self._tensor(keep, torch.long)
            self.last_token[keep] = tok[keep]
        return self.last_token.cpu().numpy()

    @_watched("copy_page")
    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Device half of a copy-on-write remap: copy pool page ``src``
        to ``dst`` across all layers, K and V, and the page's scales on
        an int8 pool, on every rank's head shard of a tensor-parallel
        pool; a speculative engine's draft pool too (the same block
        tables, the same remap)."""
        for c in (self.cache, self.draft_cache):
            if c is None:
                continue
            for buf in kv_tensors(c.k) + kv_tensors(c.v):
                buf[c.at(dst)] = buf[c.at(src)]

    # -- host KV tier ------------------------------------------------------
    def _page_views(self, page: int) -> list:
        """Page ``page`` of every tensor a pool page spans: K and V (int8
        rows and scales on an int8 pool) of the target's pool (every
        rank's shard), then the draft's."""
        return [
            buf[c.at(page)]
            for c in (self.cache, self.draft_cache)
            if c is not None
            for buf in kv_tensors(c.k) + kv_tensors(c.v)
        ]

    @functools.cached_property
    def page_bytes(self) -> int:
        """Bytes of one pool page across every tensor it spans (every
        layer and rank, K and V, scales, the draft pool): what a spill or
        a restore moves. 0 on the dense engine."""
        if not self.paged:
            return 0
        return sum(v.numel() * v.element_size() for v in self._page_views(0))

    def _alloc_host_tier(self) -> None:
        """The seats: one host tensor a pool tensor, ``[host_pages] +``
        its page's shape, pinned when the pool is on the card (pinning
        failure raises: the tier never falls back to pageable memory),
        plus the copy stream and the seat bookkeeping."""
        pin = self.device.type == "cuda"
        self._host_seats = [
            torch.empty((self.host_pages, *v.shape), dtype=v.dtype, pin_memory=pin)
            for v in self._page_views(0)
        ]
        self._copy_stream = torch.cuda.Stream(self.device) if pin else None
        self._host_landed: set[int] = set()  # seats holding a payload
        # Spills whose device-to-host copy may still be running: seat ->
        # its CUDA event.
        self._pending_spills: dict = {}
        self.host_spilled_pages = 0
        self.host_restreamed_pages = 0
        self.host_spill_bytes = 0
        self.host_restream_bytes = 0

    def _require_host_tier(self) -> None:
        if not self.host_pages:
            raise ValueError("the host KV tier needs Engine(kv_host_pages=...)")

    @_watched("spill_page")
    @torch.no_grad()
    def spill_page(self, device_page: int, host_page: int, *, owner=None,
                   tick: int = 0) -> None:
        """Start the spill of pool page ``device_page`` into seat
        ``host_page``: the page is gathered into fresh device tensors on
        the current stream (so a later write into the page, queued
        behind it, cannot reach the copy), then copied to the pinned
        seat on the copy stream behind an event. The seat holds the
        payload once :meth:`drain_spills` has waited on that event. The
        seat's bytes are granted in the memory ledger here (``owner`` /
        ``tick`` annotate the grant)."""
        self._require_host_tier()
        dp, hp = int(device_page), int(host_page)
        self._pending_spills.pop(hp, None)
        self._host_landed.discard(hp)
        gathered = [v.clone() for v in self._page_views(dp)]
        if self._copy_stream is None:  # the CPU: a plain copy
            for seat, g in zip(self._host_seats, gathered):
                seat[hp].copy_(g)
            self._host_landed.add(hp)
        else:
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for seat, g in zip(self._host_seats, gathered):
                    seat[hp].copy_(g, non_blocking=True)
                    g.record_stream(stream)  # kept until the copy is done
                event = torch.cuda.Event()
                event.record(stream)
            self._pending_spills[hp] = event
        self.host_spilled_pages += 1
        self.host_spill_bytes += self.page_bytes
        self.memledger.grant("kv_host_pages", self.page_bytes, owner=owner, tick=tick,
                             kind="spill")

    def drain_spills(self) -> int:
        """Wait for every spill still in flight; their seats then hold
        their payloads. Called at the tick boundary, when the copies have
        had the last tick to run. Returns the number of pages landed."""
        if not self.host_pages or not self._pending_spills:
            return 0
        pending, self._pending_spills = self._pending_spills, {}
        for hp, event in pending.items():
            event.synchronize()
            self._host_landed.add(hp)
        return len(pending)

    @_watched("restore_page")
    @torch.no_grad()
    def restore_page(self, host_page: int, device_page: int, *, release: bool = False,
                     kind: str = "restream", owner=None, tick: int = 0) -> None:
        """Write seat ``host_page`` back into pool page ``device_page``,
        whole (every tensor the spill took), on the current stream.
        A seat whose spill is still in flight drains first.
        ``release=True`` consumes the payload (a parked victim's resume);
        otherwise the seat keeps it (a host prefix entry keeps serving
        hits until promotion frees it; a released seat's bytes are freed
        in the memory ledger, ``kind`` naming why). A seat without a
        payload raises ``KeyError``."""
        self._require_host_tier()
        hp, dp = int(host_page), int(device_page)
        if hp in self._pending_spills:
            self.drain_spills()
        if hp not in self._host_landed:
            raise KeyError(f"host seat {hp} holds no payload")
        for seat, view in zip(self._host_seats, self._page_views(dp)):
            view.copy_(seat[hp].to(self.device, non_blocking=True))
        self.host_restreamed_pages += 1
        self.host_restream_bytes += self.page_bytes
        if release:
            self._host_landed.discard(hp)
            self.memledger.free("kv_host_pages", self.page_bytes, owner=owner, kind=kind)

    def host_free(self, host_page: int, *, kind: str = "host_free", owner=None,
                  tick: int = 0) -> None:
        """Drop seat ``host_page``'s payload without restoring it
        (promotion made it redundant, a cold eviction reclaimed it, or a
        resume's prefix hit covered it) and free its bytes in the memory
        ledger. A copy still in flight into the seat finishes on the copy
        stream, before any later spill's."""
        self._require_host_tier()
        hp = int(host_page)
        self._pending_spills.pop(hp, None)
        self._host_landed.discard(hp)
        self.memledger.free("kv_host_pages", self.page_bytes, owner=owner, kind=kind)

    @_watched("decode")
    @torch.no_grad()
    def decode(self, active, temp, topk) -> np.ndarray:
        """One decode tick over the slot batch; returns the per-slot
        next token (host numpy; stale for inactive slots)."""
        if self.spec_k:
            raise ValueError(
                "a speculative engine ticks through spec_draft + spec_verify "
                "(there is no plain decode step to run)"
            )
        active = self._tensor(active, torch.bool)
        c = self.cache
        # Inactive slots are free slots: their length is clamped to 0,
        # so the kernel visits one tile for them, not a retired
        # request's whole context.
        lens = torch.where(active, c.lengths, 0)
        if self.paged:
            cache = dict(
                paged_cache=(c.k, c.v, lens, self._block_tables(), active[:, None])
            )
        else:
            cache = dict(cache=(c.k, c.v, lens))
        out, _ = self.model(
            self.last_token[:, None].long(),
            return_hidden=self._blocked_head,
            **cache,
        )
        tok = self._sample_last(
            out,
            torch.zeros(self.slots, dtype=torch.long, device=self.device),
            self._tensor(temp, torch.float32),
            self._tensor(topk, torch.int32),
        )
        c.lengths = torch.where(active, lens + 1, lens)
        self.last_token = torch.where(active, tok, self.last_token)
        return self.last_token.cpu().numpy()

    def _draft_append(self, tokens, lens, active, block_tables, cap, *, with_head):
        """One T = 1 draft forward at ``lens``: logits ``[S, V]`` f32, or
        None head-less. Inactive slots' rows are not written; on the pool
        neither is a row past the slot's mapped pages (``cap``): the
        block table has no entry for it."""
        d = self.draft_cache
        valid = active[:, None]
        if self.paged:
            valid = valid & (lens[:, None] < cap[:, None])
            cache = dict(paged_cache=(d.k, d.v, lens, block_tables, valid))
        else:
            cache = dict(cache=(d.k, d.v, lens, valid))
        out, _ = self.draft_model(tokens[:, None].long(), return_hidden=not with_head, **cache)
        return out[:, 0].float() if with_head else None

    @_watched("spec_draft")
    @torch.no_grad()
    def spec_draft(self, active, temp, topk) -> None:
        """Phase 1 of a speculative tick: ``spec_k`` T = 1 draft steps per
        active slot from its last token, each proposal an exact sample
        of q (:func:`~mpit_tpu_torch.serve.spec.draft_distribution`;
        greedy rows take the draft's argmax), then one head-less append
        of the last proposal at ``lengths + k``: a fully accepted tick
        advances the length past it, and without that row the draft's
        context would keep a hole inside its window (acceptance, not the
        output, would suffer). The draft cache's rows are written at
        ``lengths .. lengths + k``; its lengths are the target's and
        advance at verify. Proposals and their probabilities stay on the
        device for :meth:`spec_verify`."""
        if not self.spec_k:
            raise ValueError("spec_draft requires Engine(spec_k=...)")
        act = self._tensor(active, torch.bool)
        temp = self._tensor(temp, torch.float32)
        topk = self._tensor(topk, torch.int32)
        lens0 = torch.where(act, self.cache.lengths, 0)
        bt = cap = None
        if self.paged:
            bt = self._block_tables()
            cap = self._tensor(self.allocator.mapped_tokens(), torch.int32)
        cur = self.last_token
        drafted, qx, qprobs = [], [], []
        for j in range(self.spec_k):
            logits = self._draft_append(cur, lens0 + j, act, bt, cap, with_head=True)
            probs, scaled = draft_distribution(logits, temp, topk)
            noise = gumbel(scaled.shape, generator=self._gen, device=self.device)
            samp = (scaled + noise).argmax(dim=-1)
            tok = torch.where(temp <= 0.0, logits.argmax(dim=-1), samp).int()
            drafted.append(tok)
            qx.append(probs.gather(1, tok.long()[:, None])[:, 0])
            qprobs.append(probs)
            cur = tok
        self._draft_append(cur, lens0 + self.spec_k, act, bt, cap, with_head=False)
        self._spec_state = (
            torch.stack(drafted, dim=1), torch.stack(qx, dim=1), torch.stack(qprobs, dim=1)
        )

    @_watched("spec_verify")
    @torch.no_grad()
    def spec_verify(self, active, temp, topk, budget, eos):
        """Phase 2: one target pass at T = k + 1 over ``[last, d_1 ..
        d_k]`` (the flash-decode kernel's T > 1 bodies on a kernel
        engine), the verify sampler over all k + 1 positions, then the
        longest accepted prefix (:func:`~mpit_tpu_torch.serve.spec.accept_emit`).
        Lengths advance by the emitted count only: rejected drafts' rows
        sit past the new length, masked, and the next append overwrites
        them — the rollback, dense and paged alike. On the dense cache an
        inactive slot keeps its rows; on the pool no row past a slot's
        mapped pages is written. ``budget`` ``[slots]`` tokens each
        request may still emit, ``eos`` ``[slots]`` its EOS id (-1:
        none). Returns host numpy ``(emit [S, k+1], n_emit [S], n_acc
        [S])``: slot ``s`` emitted ``emit[s, :n_emit[s]]``."""
        if self._spec_state is None:
            raise ValueError("spec_verify without a pending spec_draft")
        drafted, qx, qprobs = self._spec_state
        self._spec_state = None
        k = self.spec_k
        act = self._tensor(active, torch.bool)
        temp = self._tensor(temp, torch.float32)
        topk = self._tensor(topk, torch.int32)
        c = self.cache
        lens = torch.where(act, c.lengths, 0)
        feed = torch.cat([self.last_token[:, None], drafted], dim=1).long()
        if self.paged:
            pos = lens[:, None] + torch.arange(k + 1, device=self.device)
            cap = self._tensor(self.allocator.mapped_tokens(), torch.int32)
            valid = act[:, None] & (pos < cap[:, None])
            cache = dict(paged_cache=(c.k, c.v, lens, self._block_tables(), valid))
        else:
            cache = dict(cache=(c.k, c.v, lens, act[:, None].expand(-1, k + 1)))
        out, _ = self.model(feed, return_hidden=self._blocked_head, **cache)
        s = self.slots
        nrows = s * (k + 1)
        # The bonus position: q = 0 makes its residual a plain target
        # sample (max(p - 0, 0) = p), one formula for reject and bonus.
        qpad = torch.cat([qprobs, torch.zeros_like(qprobs[:, :1])], dim=1)
        drafted_pad = torch.nn.functional.pad(drafted, (0, 1))
        rows = dict(
            temperature=temp.repeat_interleave(k + 1), top_k=topk.repeat_interleave(k + 1),
            generator=self._gen,
        )
        if self._blocked_head:
            g, p_x, repl = lm_head_verify(
                out.reshape(nrows, out.shape[-1]), self.model.head_weight(),
                drafted_pad.reshape(nrows), qpad.reshape(nrows, -1),
                k_cap=self.sample_k_cap, compute_dtype=self.cfg.head_dtype, **rows,
            )
        else:
            # k_cap = vocab keeps the reference's top-k unbounded, like
            # its sampler.
            g, p_x, repl = verify_reference(
                out.reshape(nrows, -1).float(), drafted_pad.reshape(nrows),
                qpad.reshape(nrows, -1), k_cap=self.cfg.vocab_size, **rows,
            )
        u = torch.rand((s, k), generator=self._gen, device=self.device)
        emit, n_emit, n_acc = accept_emit(
            drafted, g.reshape(s, k + 1), p_x.reshape(s, k + 1)[:, :k], qx, u,
            repl.reshape(s, k + 1), temp <= 0.0, self._tensor(budget, torch.int32),
            self._tensor(eos, torch.int32),
        )
        n_emit = torch.where(act, n_emit, 0)
        n_acc = torch.where(act, n_acc, 0)
        last = emit.gather(1, (n_emit.long() - 1).clamp_min(0)[:, None])[:, 0]
        self.last_token = torch.where(act, last, self.last_token)
        c.lengths = lens + n_emit
        return emit.cpu().numpy(), n_emit.cpu().numpy(), n_acc.cpu().numpy()

    # -- roofline accounting -------------------------------------------------
    def register_roofline(self) -> dict:
        """Register each step's analytic per-execution cost
        (:func:`~mpit_tpu_torch.utils.profiling.gpt2_step_cost`) with the
        obs recorder under the span names the scheduler uses —
        ``prefill`` and ``decode``, or ``prefill``, ``spec_draft`` and
        ``spec_verify`` on a speculative engine — against the bf16 or f32
        peak as the model computes. The costs are of the padded steps:
        every slot, the prefill width (or chunk), the whole cache window;
        the scheduler feeds the decode tick's length-aware bytes
        (:meth:`decode_achieved_hbm_bytes`) as explicit work. Returns
        ``{phase: cost}``, kept as ``roofline_costs``."""
        width = self.prefill_chunk if self.paged else self.prefill_len
        kw = dict(slots=self.slots, ctx=self.max_len, param_bytes=self._param_bytes,
                  kv_row_bytes=self._kv_row_bytes)
        steps = {"prefill": gpt2_step_cost(self.cfg, "prefill", width=width, **kw)}
        if self.spec_k:
            k = self.spec_k
            dkw = dict(
                slots=self.slots, ctx=self.max_len,
                param_bytes=self.memledger.held("draft_weights"),
                kv_row_bytes=kv_wire_bytes_per_row(
                    self.draft_cfg.num_heads, self.draft_cfg.head_dim,
                    torch.int8 if self.kv_quantized
                    else kv_tensors(self.draft_cache.k)[0].dtype,
                ),
            )
            # The draft's prefill rides in the prefill call (no head).
            draft = gpt2_step_cost(self.draft_cfg, "prefill", width=width, head_rows=0, **dkw)
            for key in ("flops", "matmul_flops", "hbm_bytes"):
                steps["prefill"][key] += draft[key]
            steps["spec_draft"] = gpt2_step_cost(self.draft_cfg, "spec_draft", width=k, **dkw)
            steps["spec_verify"] = gpt2_step_cost(self.cfg, "spec_verify", width=k + 1, **kw)
        else:
            steps["decode"] = gpt2_step_cost(self.cfg, "decode", width=1, **kw)
        dtype = "bf16" if self.cfg.dtype == torch.bfloat16 else "f32"
        for phase, cost in steps.items():
            _roofline.register_cost(
                phase, flops=cost["flops"], hbm_bytes=cost["hbm_bytes"],
                platform=self.platform, source=cost["source"], dtype=dtype,
            )
        self.roofline_costs = steps
        return steps

    def decode_achieved_hbm_bytes(self, live_lens, t_q: int = 1, *,
                                  include_params: bool = True):
        """Modeled device bytes of one decode tick on the length-aware
        kernel path: the weights once, the K/V tiles the kernel visits
        for ``live_lens`` (the live slots' cache fills at the tick's
        start) at query width ``t_q`` (1, or k + 1 for a speculative
        verify), one tile for each free slot (its length is clamped to
        0), and the rows appended — at the cache's storage width (int8
        rows with their scales). The tile count is
        :func:`~mpit_tpu_torch.ops.decode_attention.num_kv_blocks`, the
        bound the kernel's own visited count follows. ``None`` on a
        reference engine (no tile skipping to account)."""
        if self.decode_attention == "reference":
            return None
        lens = np.asarray(live_lens)
        visited = num_kv_blocks(lens, t_q, self.max_len, self.decode_block_k)
        total_tiles = int(visited.sum()) + (self.slots - lens.size)
        return _roofline.decode_step_hbm_bytes(
            total_tiles,
            block_k=self.decode_block_k,
            kv_row_bytes=self._kv_row_bytes,
            num_layers=self.cfg.num_layers,
            param_bytes=self._param_bytes if include_params else 0.0,
            appended_rows=lens.size * t_q,
        )

    def lengths(self) -> np.ndarray:
        return self.cache.lengths.cpu().numpy()

    @torch.no_grad()
    def export_kv_rows(self, slot: int, length: int):
        """``slot``'s first ``length`` cached KV rows in the canonical dense
        row layout ``[L, length, H, Dh]`` (an int8 cache gives a
        :class:`~mpit_tpu_torch.ops.kv_quant.QuantizedKV` of int8 rows and
        ``[L, length, H, 1]`` scales), as new contiguous tensors on the
        engine's device. Dense and paged engines give identical rows for
        identical fills — a paged export gathers the slot's block-table
        pages and trims the tail — so a fleet shipment packed from either
        injects into either. Returns ``(k_rows, v_rows)``. A
        tensor-parallel engine raises (:meth:`_refuse_tp_shipment`)."""
        self._refuse_tp_shipment()
        if length <= 0:
            raise ValueError(f"export_kv_rows needs length > 0, got {length}")
        if self.paged:
            npages = -(-length // self.page_size)
            pages = self._tensor(self.allocator.block_tables[slot, :npages], torch.long)

            def rows(buf):
                arr = buf[:, pages]  # [L, npages, page_size, H, last]
                nl, n, p, h, last = arr.shape
                return arr.reshape(nl, n * p, h, last)[:, :length].contiguous()

        else:

            def rows(buf):
                return buf[:, slot, :length].contiguous()

        return tuple(
            QuantizedKV(q=rows(buf.q), scale=rows(buf.scale))
            if isinstance(buf, QuantizedKV) else rows(buf)
            for buf in (self.cache.k, self.cache.v)
        )

    @torch.no_grad()
    def inject_kv_rows(
        self, slot: int, k_rows, v_rows, length: int, first_token: int
    ) -> None:
        """Inverse of :meth:`export_kv_rows`: install ``length`` rows of
        shipped KV state into ``slot`` and arm it for decode —
        ``lengths[slot] = length``, ``last_token[slot] = first_token``
        (the token the shipping side sampled at prefill end). On a paged
        engine the caller has already run ``allocator.admit`` for the
        slot (all-or-nothing, no ``register_prefix`` — injected pages are
        private, never prefix-shared); rows scatter into the slot's
        mapped pages. ``k_rows``/``v_rows`` match the export layout —
        tensors, or objects with ``.q``/``.scale`` for an int8 cache —
        and are cast to the cache's device and dtype. A tensor-parallel
        engine raises (:meth:`_refuse_tp_shipment`)."""
        self._refuse_tp_shipment()
        if self.paged:
            ps = self.page_size
            npages = -(-length // ps)
            pages = [int(p) for p in self.allocator.block_tables[slot, :npages]]

            def put(buf, rows):
                for i, page in enumerate(pages):
                    n = min(ps, length - i * ps)
                    buf[:, page, :n] = rows[:, i * ps : i * ps + n]

        else:

            def put(buf, rows):
                buf[:, slot, :length] = rows

        for buf, rows in ((self.cache.k, k_rows), (self.cache.v, v_rows)):
            pairs = (
                ((buf.q, rows.q), (buf.scale, rows.scale))
                if isinstance(buf, QuantizedKV) else ((buf, rows),)
            )
            for dst, src in pairs:
                put(dst, src.to(device=dst.device, dtype=dst.dtype))
        self.arm_slot(slot, length, first_token)

    def arm_slot(self, slot: int, length: int, last_token: int) -> None:
        """Arm ``slot`` for the next tick: its cache holds ``length`` rows
        (injected, or restored from the host tier) and ``last_token`` is
        its newest token, whose row the tick writes."""
        self.cache.lengths[slot] = int(length)
        self.last_token[slot] = int(last_token)

    def _refuse_tp_shipment(self) -> None:
        """The fleet's KV shipment moves one device's whole rows; a
        head-sharded cache's rows are cut over the ranks."""
        if self.tp:
            raise ValueError(
                "export_kv_rows / inject_kv_rows on a tensor-parallel engine: the "
                "fleet's KV shipment of head-sharded rows arrives with the fleet over "
                "tensor parallelism (ROADMAP.md §A 8c)"
            )

    def reset(self, seed: int = 0) -> None:
        """Clear all slots (and the page bookkeeping) and re-seed the
        sampler."""
        for c in (self.cache, self.draft_cache):
            if c is None:
                continue
            for buf in kv_tensors(c.k) + kv_tensors(c.v):
                buf.zero_()
        self._spec_state = None
        self.cache.lengths.zero_()
        self.last_token.zero_()
        self._gen.manual_seed(seed)
        ml = self.memledger
        if self.host_pages:
            # The tier empties with the pool: wait for copies in flight,
            # drop every payload, zero the counters, free its bytes.
            self.drain_spills()
            self._host_landed.clear()
            self.host_spilled_pages = 0
            self.host_restreamed_pages = 0
            self.host_spill_bytes = 0
            self.host_restream_bytes = 0
            if ml.held("kv_host_pages"):
                ml.free("kv_host_pages", ml.held("kv_host_pages"), kind="reset")
        if self.paged:
            self.allocator.reset()  # frees its pages and reserves in the ledger
        elif ml.held("kv_slots"):
            ml.free("kv_slots", ml.held("kv_slots"), kind="reset")
        # Owner recency and exhaustion forensics describe the last run;
        # the static grants stay (so do the tensors).
        ml.reset_transients()
