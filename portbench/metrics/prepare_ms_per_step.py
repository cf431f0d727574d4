"""prepare_ms_per_step: host time in the ``kkt.prepare`` range (the
derivative oracles and the KKT assembly of each Newton step) per Newton
step, in the traced calls."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    ns = ctx.trace.range_ns({"kkt.prepare"})
    return ns / 1e6 / steps if ns else None
