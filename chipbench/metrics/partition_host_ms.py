"""Host time a batch in the stream partition outside the engine call.

Layer: stream partitioning (`core/stream_partition.py`): the self time of
the program's span `eq.partition` less its `eq.engine` child (the
coercion, the pad, the unfold, the merge's slice and reshape, and the
host's time between them), on the host clock, mean over the traced
batches. Moves `eq_latency_p95_ms`.
"""
from chipbench.metrics.engine_host_ms import per_batch_ms


def read(ctx):
    return per_batch_ms("eq.partition", minus="eq.engine")
