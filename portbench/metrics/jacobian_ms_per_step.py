"""jacobian_ms_per_step: host time in the port's ``oracle.jacobian`` spans
(the vmapped instance constraint Jacobians of ``kkt.prepare``) per Newton
step, in the traced calls.
Counts spans inside the traced window only; None without
``oracle.jacobian`` spans."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    ns = [e - s for n, s, e in ctx.trace.ranges
          if n == "oracle.jacobian" and s >= w0 and e <= w1]
    return sum(ns) / 1e6 / steps if ns else None
