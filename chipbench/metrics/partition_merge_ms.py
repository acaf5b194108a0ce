"""Device time a batch of the stream partition's merge.

Layer: stream partitioning (`core/stream_partition.py`): the time between
the CUDA events of the program's span `eq.partition.merge` (the copy of
the kept symbols), mean over the traced batches. Moves `eq_sym_per_s`.
"""
from chipbench.metrics.engine_host_ms import per_batch_ms


def read(ctx):
    return per_batch_ms("eq.partition.merge", device=True)
