"""Device time a batch spends in kernels other than the equalizer's.

Layer: stream partitioning (`core/stream_partition.py`): the pad of the
stream and the merge's copy, from the profiler's device timeline, over
the traced batches. Moves `eq_sym_per_s`.
"""


def read(ctx):
    trace = getattr(ctx, "trace", None)
    if not trace or not trace["by_name"]:
        return None
    other = sum(s for name, s in trace["by_name"].items()
                if "cnn_eq" not in name)
    return 1e3 * other / ctx.traced["batches"]
