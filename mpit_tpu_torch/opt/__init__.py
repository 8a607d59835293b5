"""Optimizers of the port: the goo update rules and their lr schedules.
Their ZeRO-1 sharding over a World's ranks is
``mpit_tpu_torch.opt.sharded`` (not re-exported: its function ``sharded``
would hide the module)."""

from mpit_tpu_torch.opt import schedules
from mpit_tpu_torch.opt.goo import (
    AdamState, ElasticState, GooState, chain, elastic_average, goo, goo_adam,
)

__all__ = [
    "AdamState", "ElasticState", "GooState", "chain", "elastic_average", "goo", "goo_adam",
    "schedules",
]
