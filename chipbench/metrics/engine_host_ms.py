"""Host time a batch in the engine call outside the kernel's launch.

Layer: engine and kernel wrapper (`core/engine.py`,
`kernels/cnn_eq/cnn_eq.py`): the self time of the program's span
`eq.engine` less its `eq.cnn_eq.launch` children (the closure, the casts,
the checks, the plan, the ctypes marshalling), on the host clock, mean
over the traced batches. Moves `eq_latency_p95_ms`.

`per_batch_ms` is the reduction every span reader shares: the program's
ring of hot-path spans (`repro_torch.obs.trace`) after the traced window,
the first root dropped (the profiler's warm batch, which the harness
drops from its calls too), a span's value less its direct children named
``minus``, summed over each batch and averaged over the batches. None
where the program records no spans, holds no such span, or, for device
time, recorded no CUDA events.
"""


def per_batch_ms(name, minus=None, device=False):
    try:
        from repro_torch.obs.trace import span_records
    except ImportError:             # a program without hot-path spans
        return None
    recs = span_records()
    batches = [r.sid for r in recs if r.parent is None][1:]
    kept = set(batches)
    spans = [r for r in recs if r.name == name and r.batch in kept]
    if not spans:
        return None
    if device:
        values = [r.device_ms for r in spans]
        if None in values:
            return None
        return sum(values) / len(batches)
    own = {r.sid for r in spans}
    total = sum(r.host_ms for r in spans) - sum(
        r.host_ms for r in recs if r.name == minus and r.parent in own)
    return total / len(batches)


def read(ctx):
    return per_batch_ms("eq.engine", minus="eq.cnn_eq.launch")
