"""The whole step's share of the card's dense peak, in percent.

Layer: whole step. Kept symbols a second in the untraced window times the
operations a kept symbol needs (2 x the multiply-accumulates of the
topology, `chipbench.yardstick.ops_per_symbol`), over the backend's dense
peak. It counts kept symbols only, so it reads the same work whatever
computes it. Moves `eq_sym_per_s`.
"""
from chipbench import yardstick


def read(ctx):
    win = ctx.window
    if not win["batches"] or not win["seconds"]:
        return None
    rate = win["batches"] * ctx.system.kept_symbols / win["seconds"]
    peak = yardstick.PEAK_OPS_S[yardstick.BACKEND_PEAK[ctx.config["backend"]]]
    return 100.0 * rate * yardstick.ops_per_symbol(ctx.config["cnn"]) / peak
