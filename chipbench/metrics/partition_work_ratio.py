"""Symbols the engine computed over symbols kept, in the traced batches.

Layer: stream partitioning (`core/stream_partition.py`). Counts the
engine calls' outputs as the program made them (recorded at the engine's
boundary) against the kept symbols of the same batches; the overlap the
partition adds is what it wastes. Moves `eq_sym_per_s`.
"""


def read(ctx):
    calls = getattr(ctx, "calls", None)
    if not calls:
        return None
    return (sum(c["out"] for c in calls)
            / (ctx.traced["batches"] * ctx.system.kept_symbols))
