"""Host time a batch in the ctypes call that launches the cnn_eq kernel.

Layer: engine and kernel wrapper (`kernels/cnn_eq/cnn_eq.py`): the
program's span `eq.cnn_eq.launch` (one a batch on the card, none on the
CPU), on the host clock, mean over the traced batches. Moves
`eq_latency_p95_ms`.
"""
from chipbench.metrics.engine_host_ms import per_batch_ms


def read(ctx):
    return per_batch_ms("eq.cnn_eq.launch")
