"""host_syncs_per_step: blocking reads of the device per Newton step in
the traced calls -- the number of the port's ``sync.<site>`` spans, one a
read.  Counts spans inside the traced window only; None without
``sync.*`` spans."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    n = sum(1 for name, s, e in ctx.trace.ranges
            if name.startswith("sync.") and s >= w0 and e <= w1)
    return n / steps if n else None
