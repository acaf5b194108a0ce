"""Share of the traced window in which no device activity ran, percent.

Layer: device. From the profiler's timeline: one minus the union of the
kernels', copies' and sets' intervals over the window's length. Moves
`eq_sym_per_s`.
"""


def read(ctx):
    trace = getattr(ctx, "trace", None)
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
