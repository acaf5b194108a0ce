"""Elastic scaling: resume a job on a DIFFERENT rank count / mesh shape.

Port of `repro.runtime.elastic`. Checkpoints are mesh-agnostic (logical
tensors + path-based sharding rules, `checkpoint.manager`), so elasticity
is a restore:

    1. find the surviving ranks (after losing or gaining hosts),
    2. build the largest valid mesh (`best_mesh`),
    3. restore the checkpoint with the new mesh's placements,
    4. re-derive the data-pipeline sharding and continue.

The batch contract is preserved: the GLOBAL batch and the synthetic data
stream are functions of the step only, so training curves are bit-stable
across reshards up to reduction order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from ..checkpoint.manager import CheckpointManager
from ..parallel import sharding as shardlib


def best_mesh(n_devices: Optional[int] = None, model_parallel: int = 0,
              ranks: Optional[List[int]] = None,
              device_type: Optional[str] = None):
    """Largest ("data", "model") `DeviceMesh` for the surviving ranks.

    The implementation lives with the rest of the device-set logic in
    `repro_torch.serve.fleet`; this re-export keeps the reference's
    `runtime.best_mesh` import path. The import is lazy to avoid a cycle
    (runtime → serve → runtime.straggler)."""
    from ..serve.fleet import best_mesh as _best_mesh
    return _best_mesh(n_devices=n_devices, model_parallel=model_parallel,
                      ranks=ranks, device_type=device_type)


@dataclasses.dataclass
class ElasticRestore:
    ckpt: CheckpointManager
    mode: str = "train"

    def restore(self, template: Any, mesh,
                step: Optional[int] = None) -> Tuple[Any, int]:
        """(state tree of DTensors, step) resharded onto ``mesh`` (a
        `DeviceMesh`; every rank of the world calls it)."""
        specs = shardlib.param_specs(template, mesh, self.mode)
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint to restore elastically")
        state = self.ckpt.restore(template, step=step, mesh=mesh,
                                  specs=specs)
        return state, step
