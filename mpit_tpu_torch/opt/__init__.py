"""Optimizers of the port: the goo update rules and their lr schedules."""

from mpit_tpu_torch.opt import schedules
from mpit_tpu_torch.opt.goo import AdamState, GooState, goo, goo_adam

__all__ = ["AdamState", "GooState", "goo", "goo_adam", "schedules"]
