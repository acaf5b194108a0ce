"""Parallelism of the port (`repro.parallel` counterparts), SPMD over
`torch.distributed`: `sharding` (the mesh context, the path-based
parameter rules, DTensor placements and the TP head resolution) and
`halo` (the paper's stream partitioning over ranks, by halo exchange)."""
from . import halo, sharding

__all__ = ["halo", "sharding"]
