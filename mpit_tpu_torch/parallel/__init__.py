"""Model parallelism of the port: tensor parallelism on the ``model``
axis (:mod:`mpit_tpu_torch.parallel.megatron`), the rules, specs and
FSDP cut of tensor-parallel training (:mod:`mpit_tpu_torch.parallel.tp`)
and context parallelism on the ``seq`` axis
(:mod:`mpit_tpu_torch.parallel.cp` over
:mod:`~mpit_tpu_torch.parallel.ring_attention` and
:mod:`~mpit_tpu_torch.parallel.ulysses`)."""

from mpit_tpu_torch.parallel import cp, megatron, ring_attention, tp, ulysses
from mpit_tpu_torch.parallel.cp import make_gpt2_cp_train_step, make_seq_attention
from mpit_tpu_torch.parallel.tp import (
    fsdp_rules,
    gpt2_tp_rules,
    make_tp_train_step,
    param_partition_specs,
    specs_like_params,
)

__all__ = [
    "cp", "fsdp_rules", "gpt2_tp_rules", "make_gpt2_cp_train_step", "make_seq_attention",
    "make_tp_train_step", "megatron", "param_partition_specs", "ring_attention",
    "specs_like_params", "tp", "ulysses",
]
