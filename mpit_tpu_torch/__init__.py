"""mpit_tpu_torch: the PyTorch + CUDA port of :mod:`mpit_tpu` for NVIDIA
Hopper (H100).

Serving: GPT-2 through the continuous-batching engine (``python -m
mpit_tpu_torch.serve``), with the flash-decode attention in a
hand-written CUDA kernel (``csrc/decode_attention.cu``) and, with the
int8 weight store, the dense layers in another
(``csrc/quantized_matmul.cu``). Training: GPT-2 (``python -m
mpit_tpu_torch.asyncsgd gpt2``) on one rank or data-parallel over a
World of ranks with ZeRO-1, with the flash attention's forward and
backward in three more kernels (``csrc/flash_attention.cu``) and the
gradient sync's ring reduce-scatter and all-gather in four
(``csrc/ring_collectives.cu``). The mpiT facade (``compat``) runs
rank-role programs over threads; the serving fleet (``--fleet``) stands
on it, its KV shipments moving card to card through a copy kernel
(``csrc/kv_ship.cu``). The package
imports torch, numpy and the standard library only; it never imports
JAX or :mod:`mpit_tpu`.
"""
