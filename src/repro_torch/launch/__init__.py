"""Launchers of the port (`repro.launch` counterparts): `steps` (the
gradient-accumulating train step, prefill and greedy decode steps),
`train` (the LM training driver, ``python -m repro_torch.launch.train``)
and `serve` (the batched prefill + decode driver,
``python -m repro_torch.launch.serve``)."""
