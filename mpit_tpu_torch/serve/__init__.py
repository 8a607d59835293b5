"""mpit_tpu_torch.serve — continuous-batching GPT-2 inference on the GPU.

- :mod:`~mpit_tpu_torch.serve.kvcache` — ``[layers, slots, max_len,
  heads, head_dim]`` K/V buffers + per-slot lengths, or a paged pool
  with its host page allocator (prefix sharing, copy-on-write); f32,
  bf16 or int8 with scales.
- :mod:`~mpit_tpu_torch.serve.engine` — prefill (whole prompts, or
  chunks on the pool) and decode over the slot batch, attention through
  the flash-decode CUDA kernel and sampling through the blocked LM head
  (``decode_attention="kernel"``), or the plain reference path
  (``"reference"``), the parity oracle; ``weights_dtype="int8"`` serves
  the int8 weight store through the fused-dequant matmul kernel;
  ``world=`` / ``tp_axis=`` serve tensor-parallel (:mod:`~mpit_tpu_torch.serve.tp`:
  Megatron blocks over the ranks of the ``model`` axis, a head-sharded
  cache).
- :mod:`~mpit_tpu_torch.serve.scheduler` — the continuous-batching
  loop: queue → admit into freed slots (and pages) between decode ticks
  → per-slot retirement (EOS / max tokens / cache full), with obs spans
  and the stream registry's windows; bounded intake, preemption and the
  host KV tier's spills and restreams; ``run`` (closed loop) and
  ``run_timed`` (an open-loop trace by its clock).
- :mod:`~mpit_tpu_torch.serve.loadgen` — seeded open-loop arrival traces
  (``LoadSpec``, ``RequestClass``, ``generate_arrivals``,
  ``split_arrivals``, ``parse_load_spec``).
- :mod:`~mpit_tpu_torch.serve.spec` — speculative decoding's math
  (the proposal, the acceptance, the full-logits verifier); the engine
  runs it with ``Engine(spec_k=..., draft_params=..., draft_cfg=...)``.
- :mod:`~mpit_tpu_torch.serve.weights` — the dense ``.npz`` reader, the
  JAX param tree → ``state_dict`` carry-over, the int8 weight store
  (``quantize_gpt2_params``, ``params_wire_bytes``), the state cut for
  tensor parallelism (``shard_gpt2_params``) and the layer-truncated
  self-draft (``draft_from_target``).
- :mod:`~mpit_tpu_torch.serve.shipment` — a prefill's KV rows as three
  wire messages (the JAX package's bytes); on the card the payload moves
  through the CUDA copy kernel (``ship_kv_remote``).
- :mod:`~mpit_tpu_torch.serve.fleet` — the disaggregated fleet over the
  compat layer: router, prefill and decode workers (``run_fleet``).
- :mod:`~mpit_tpu_torch.serve.policy` — the scheduling policy
  (``SchedulingPolicy``, ``PolicyConfig``, ``parse_policy_spec``:
  priority tiers, tenant-fair order, admission shedding, preemption
  verdicts) and ``TTFTProjector``, its and the fleet router's admission
  estimate.

``python -m mpit_tpu_torch.serve`` serves a synthetic stream (``--fleet``:
through the fleet).
"""

from mpit_tpu_torch.serve.engine import Engine, resolve_device, sample_tokens
from mpit_tpu_torch.serve.fleet import FleetConfig, parse_fleet_spec, run_fleet
from mpit_tpu_torch.serve.kvcache import (
    AdmitPlan,
    KVCache,
    PageAllocator,
    PagedKVCache,
    alloc_cache,
    alloc_paged_cache,
    pages_needed,
)
from mpit_tpu_torch.serve.loadgen import (
    Arrival,
    LoadSpec,
    RequestClass,
    generate_arrivals,
    parse_load_spec,
    split_arrivals,
)
from mpit_tpu_torch.serve.policy import (
    PolicyConfig,
    SchedulingPolicy,
    TTFTProjector,
    parse_policy_spec,
)
from mpit_tpu_torch.serve.scheduler import Completed, Request, Server, warm_engine
from mpit_tpu_torch.serve.shipment import (
    KVShipment,
    inject_shipment,
    pack_shipment,
    recv_shipment,
    send_shipment,
    ship_kv_remote,
    unpack_shipment,
)
from mpit_tpu_torch.serve.weights import (
    draft_from_target,
    expected_param_shapes,
    infer_config,
    load_dense,
    load_gpt2_params,
    params_from_jax,
    params_wire_bytes,
    quantize_gpt2_params,
    join_gpt2_params,
    shard_gpt2_params,
    validate_params,
)

__all__ = [
    "AdmitPlan",
    "Arrival",
    "Completed",
    "Engine",
    "FleetConfig",
    "KVCache",
    "KVShipment",
    "LoadSpec",
    "PageAllocator",
    "PagedKVCache",
    "PolicyConfig",
    "Request",
    "RequestClass",
    "SchedulingPolicy",
    "Server",
    "TTFTProjector",
    "alloc_cache",
    "alloc_paged_cache",
    "draft_from_target",
    "expected_param_shapes",
    "generate_arrivals",
    "infer_config",
    "inject_shipment",
    "load_dense",
    "load_gpt2_params",
    "pack_shipment",
    "pages_needed",
    "params_from_jax",
    "params_wire_bytes",
    "parse_fleet_spec",
    "parse_load_spec",
    "parse_policy_spec",
    "quantize_gpt2_params",
    "recv_shipment",
    "resolve_device",
    "run_fleet",
    "sample_tokens",
    "send_shipment",
    "join_gpt2_params",
    "shard_gpt2_params",
    "ship_kv_remote",
    "split_arrivals",
    "unpack_shipment",
    "validate_params",
    "warm_engine",
]
