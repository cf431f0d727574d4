"""oracle_point_ms_per_step: host time in the port's ``oracle.point`` spans
(the IPM's evaluations of f, g, h, grad f and the Jacobian products at a
point: the iterate, trial points, SOC, restoration, ladder, polish) per
Newton step, in the traced calls.
Counts spans inside the traced window only; None without
``oracle.point`` spans."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    ns = [e - s for n, s, e in ctx.trace.ranges
          if n == "oracle.point" and s >= w0 and e <= w1]
    return sum(ns) / 1e6 / steps if ns else None
