"""refine_ms_per_step: host time in the port's ``kkt.refine`` spans (one
refinement pass of the float64 BBD solve: the residual's ``bbd_matvec``
and its re-solve) per Newton step, in the traced calls.
Counts spans inside the traced window only; None without ``kkt.refine``
spans (float32 opens none)."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    ns = [e - s for n, s, e in ctx.trace.ranges
          if n == "kkt.refine" and s >= w0 and e <= w1]
    return sum(ns) / 1e6 / steps if ns else None
