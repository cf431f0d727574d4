"""line_search_ms_per_step: host time in the port's ``ipm.line_search``
spans (full-step acceptance, KKT-decrease test, SOC, backtracking,
restoration) per Newton step, in the traced calls.
Counts spans inside the traced window only; None without
``ipm.line_search`` spans."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    w0, w1 = ctx.trace.window
    ns = [e - s for n, s, e in ctx.trace.ranges
          if n == "ipm.line_search" and s >= w0 and e <= w1]
    return sum(ns) / 1e6 / steps if ns else None
