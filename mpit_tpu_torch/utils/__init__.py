"""Timing, tracing and cost accounting of the port
(:mod:`mpit_tpu_torch.utils.profiling`)."""

from mpit_tpu_torch.utils.profiling import (
    ChipSpec,
    CommModel,
    H100_SXM,
    StepTimer,
    allreduce_gbps,
    collective_bytes,
    gpt2_step_cost,
    modeled_all_gather_seconds,
    modeled_allreduce_seconds,
    modeled_reduce_scatter_seconds,
    roofline,
    scaling_projection,
    trace,
    tree_bytes,
)

__all__ = [
    "ChipSpec",
    "CommModel",
    "H100_SXM",
    "StepTimer",
    "allreduce_gbps",
    "collective_bytes",
    "gpt2_step_cost",
    "modeled_all_gather_seconds",
    "modeled_allreduce_seconds",
    "modeled_reduce_scatter_seconds",
    "roofline",
    "scaling_projection",
    "trace",
    "tree_bytes",
]
