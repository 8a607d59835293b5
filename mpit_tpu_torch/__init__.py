"""mpit_tpu_torch: the PyTorch + CUDA port of :mod:`mpit_tpu` for NVIDIA
Hopper (H100).

Serving slice: GPT-2 through the continuous-batching engine
(``python -m mpit_tpu_torch.serve``), with the flash-decode attention in
a hand-written CUDA kernel (``csrc/decode_attention.cu``) and, with the
int8 weight store, the dense layers in another
(``csrc/quantized_matmul.cu``). The package imports torch, numpy and
the standard library only; it never imports JAX or :mod:`mpit_tpu`.
"""
