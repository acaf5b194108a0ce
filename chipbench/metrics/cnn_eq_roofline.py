"""The cnn_eq kernel's share of its roofline, in percent.

Layer: the CUDA kernel (`kernels/cnn_eq/csrc/cnn_eq.cu`). For each
traced engine call, the least time the card could take at the call's own
shapes: the larger of its bytes (each input byte read once, each output
byte written once) at the HBM rate and its operations at the backend's
dense peak (`chipbench.yardstick`). Their sum over the profiler's device
time of the kernels named cnn_eq. At these shapes the bytes bound it.
Moves `eq_sym_per_s`.
"""
from chipbench import yardstick


def read(ctx):
    calls, trace = getattr(ctx, "calls", None), getattr(ctx, "trace", None)
    if not calls or not trace:
        return None
    kernel_s = sum(s for name, s in trace["by_name"].items()
                   if "cnn_eq" in name)
    if not kernel_s:
        return None
    least = sum(yardstick.roofline_s(
        yardstick.call_bytes(c["rows"], c["width"], c["row_stride"],
                             c["out"]),
        2 * yardstick.call_macs(ctx.config["cnn"], c["rows"], c["width"]),
        ctx.config["backend"])[0] for c in calls)
    return 100.0 * least / kernel_s
