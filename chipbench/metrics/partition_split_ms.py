"""Device time a batch of the stream partition's split.

Layer: stream partitioning (`core/stream_partition.py`): the time between
the CUDA events of the program's span `eq.partition.split` (the pad's
fill and copy), mean over the traced batches. Moves `eq_sym_per_s`.
"""
from chipbench.metrics.engine_host_ms import per_batch_ms


def read(ctx):
    return per_batch_ms("eq.partition.split", device=True)
