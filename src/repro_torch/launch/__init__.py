"""Launchers of the port (`repro.launch` counterparts). So far the serving
path: `steps` (prefill and greedy decode steps) and `serve` (the batched
prefill + decode driver, ``python -m repro_torch.launch.serve``)."""
