"""Parallelism helpers of the port. So far only the head-count resolution
of `repro.parallel.sharding` (pure Python); the mesh rules and the halo
exchange come with later slices."""
