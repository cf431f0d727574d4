"""sync_wait_ms_per_step: host time spent waiting for the card per Newton
step in the traced calls -- the summed length of the port's
``sync.<site>`` spans.  Counts spans inside the traced window only; None
without ``sync.*`` spans."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    ns = [e - s for name, s, e in ctx.trace.ranges
          if name.startswith("sync.") and s >= w0 and e <= w1]
    return sum(ns) / 1e6 / steps if ns else None
