"""Fault-tolerant training loop: checkpoint/restart with failure injection.

Port of `repro.runtime.fault`. A training job is a pure function of
(checkpoint, data stream): any failure reduces to "restart from the last
durable step". `run_with_restarts` saves through `CheckpointManager` every
``checkpoint_every`` steps (and at the end), and on a `WorkerFailure`
restores the latest checkpoint, rebuilds the data iterator at that step
and goes on, up to ``max_restarts`` times. `FailureInjector` raises
failures on a fixed schedule for tests and demos.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, Optional

from ..checkpoint.manager import CheckpointManager

log = logging.getLogger(__name__)


class WorkerFailure(RuntimeError):
    """A (simulated or real) worker fault during a step."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: fail at steps."""
    fail_at: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    max_restarts: int = 10
    log_every: int = 10


def run_with_restarts(
    loop_cfg: TrainLoopConfig,
    ckpt: CheckpointManager,
    init_state: Callable[[], Any],          # () → (params, opt_state)
    train_step: Callable[..., Any],         # (params, opt, batch) → (p,o,metrics)
    batches: Callable[[int], Iterator],     # start_step → batch iterator
    injector: Optional[FailureInjector] = None,
    on_step: Optional[Callable[[int, Dict], None]] = None,
) -> Dict[str, Any]:
    """Run to total_steps, surviving failures. Returns {"steps",
    "restarts", "history" [(step, loss) every log_every steps], "final"
    (params, opt_state)}."""
    restarts = 0
    history: list = []

    while True:
        # ---- (re)start: restore or init --------------------------------
        start = ckpt.latest_step()
        if start is not None:
            params, opt_state = ckpt.restore(init_state())
            step = start
            log.info("restored checkpoint at step %d", step)
        else:
            params, opt_state = init_state()
            step = 0
        it = batches(step)

        try:
            while step < loop_cfg.total_steps:
                batch = next(it)
                if injector is not None:
                    injector.check(step)
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                step += 1
                if on_step is not None:
                    on_step(step, metrics)
                if step % loop_cfg.log_every == 0:
                    loss = float(metrics["loss"])
                    history.append((step, loss))
                    log.info("step %d loss %.4f", step, loss)
                if step % loop_cfg.checkpoint_every == 0 \
                        or step == loop_cfg.total_steps:
                    ckpt.save(step, (params, opt_state),
                              extra={"step": step})
            return {"steps": step, "restarts": restarts,
                    "history": history,
                    "final": (params, opt_state)}
        except WorkerFailure as e:
            restarts += 1
            log.warning("worker failure (%s); restart %d/%d", e, restarts,
                        loop_cfg.max_restarts)
            if restarts > loop_cfg.max_restarts:
                raise
            # fall through: restore from the last durable checkpoint
            del params, opt_state
            continue
