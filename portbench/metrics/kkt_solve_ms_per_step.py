"""kkt_solve_ms_per_step: host time in the ``kkt.solve`` range (the
condensed KKT solve: BBD root, band sweep, back-substitution) per Newton
step, in the traced calls."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    ns = ctx.trace.range_ns({"kkt.solve"})
    return ns / 1e6 / steps if ns else None
