"""Host time of the call that enqueues one batch, mean over the window.

Layer: engine and kernel wrapper (`core/engine.py`,
`kernels/cnn_eq/cnn_eq.py`): host clock around the entry's call in the
untraced window, which returns once the batch's kernels are enqueued.
Moves `eq_latency_p95_ms`.
"""


def read(ctx):
    submit = ctx.window["submit_s"]
    return 1e3 * sum(submit) / len(submit) if submit else None
