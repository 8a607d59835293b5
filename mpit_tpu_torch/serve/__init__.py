"""mpit_tpu_torch.serve — continuous-batching GPT-2 inference on the GPU.

- :mod:`~mpit_tpu_torch.serve.kvcache` — ``[layers, slots, max_len,
  heads, head_dim]`` K/V buffers + per-slot lengths.
- :mod:`~mpit_tpu_torch.serve.engine` — prefill and decode over the
  whole slot batch, attention through the flash-decode CUDA kernel and
  sampling through the blocked LM head (``decode_attention="kernel"``),
  or the plain reference path (``"reference"``), the parity oracle.
- :mod:`~mpit_tpu_torch.serve.scheduler` — the FIFO continuous-batching
  loop: queue → admit into freed slots between decode ticks → per-slot
  retirement (EOS / max tokens / cache full), with obs spans.
- :mod:`~mpit_tpu_torch.serve.weights` — the dense ``.npz`` reader and
  the JAX param tree → ``state_dict`` carry-over.

``python -m mpit_tpu_torch.serve`` serves a synthetic stream.
"""

from mpit_tpu_torch.serve.engine import Engine, resolve_device, sample_tokens
from mpit_tpu_torch.serve.kvcache import KVCache, alloc_cache
from mpit_tpu_torch.serve.scheduler import Completed, Request, Server, warm_engine
from mpit_tpu_torch.serve.weights import (
    expected_param_shapes,
    infer_config,
    load_dense,
    load_gpt2_params,
    params_from_jax,
    validate_params,
)

__all__ = [
    "Completed",
    "Engine",
    "KVCache",
    "Request",
    "Server",
    "alloc_cache",
    "expected_param_shapes",
    "infer_config",
    "load_dense",
    "load_gpt2_params",
    "params_from_jax",
    "resolve_device",
    "sample_tokens",
    "validate_params",
    "warm_engine",
]
