"""ipm_self_ms_per_step: host time in the IPM loop's own work per Newton
step -- the ``ipm.evals`` and ``ipm.step`` ranges less the ``kkt.prepare``
and ``kkt.solve`` ranges inside them (convergence test, line search,
filter, trial evaluations) -- in the traced calls."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    ns = ctx.trace.self_ns({"ipm.evals", "ipm.step"},
                           {"kkt.prepare", "kkt.solve"})
    if ns <= 0:
        return None
    return ns / 1e6 / steps
