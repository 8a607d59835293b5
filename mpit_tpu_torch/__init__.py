"""mpit_tpu_torch: the PyTorch + CUDA port of :mod:`mpit_tpu` for NVIDIA
Hopper (H100).

Serving: GPT-2 through the continuous-batching engine (``python -m
mpit_tpu_torch.serve``), with the flash-decode attention in a
hand-written CUDA kernel (``csrc/decode_attention.cu``) and, with the
int8 weight store, the dense layers in another
(``csrc/quantized_matmul.cu``). Training: GPT-2 on one GPU (``python -m
mpit_tpu_torch.asyncsgd gpt2``), with the flash attention's forward and
backward in three more (``csrc/flash_attention.cu``). The package
imports torch, numpy and the standard library only; it never imports
JAX or :mod:`mpit_tpu`.
"""
