"""Communication of the port: the single-controller :class:`World` of
ranks and the plain collectives over its rank-stacked tensors."""

from mpit_tpu_torch.comm import collectives
from mpit_tpu_torch.comm.mesh import DATA_AXIS, World, init

__all__ = ["DATA_AXIS", "World", "collectives", "init"]
