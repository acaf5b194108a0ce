"""Launchers of the port (`repro.launch` counterparts): `mesh` (device
meshes over a `torch.distributed` world, the production mesh's shape, and
`run_ranks`, which spawns a world of ranks on this host), `steps` (the
gradient-accumulating train step, prefill and greedy decode steps),
`train` (the LM training driver, ``python -m repro_torch.launch.train``)
and `serve` (the batched prefill + decode driver,
``python -m repro_torch.launch.serve``)."""
