"""call_overhead_ms_per_call: host time of the batched entry and the IPM's
edges per traced call -- the port's ``batch.solve`` spans less the
``ipm.evals`` and ``ipm.step`` spans inside them (the inputs' conversions,
x0 into pvec, ``ipm.init``, the loop's own tests, ``ipm.finish``, u0).
Counts spans inside the traced window only; None without ``batch.solve``
spans."""
from portbench.harness.trace import union_ns


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    w0, w1 = ctx.trace.window
    inside = [r for r in ctx.trace.ranges if r[1] >= w0 and r[2] <= w1]
    calls = [(s, e) for n, s, e in inside if n == "batch.solve"]
    if not calls:
        return None
    work = [(s, e) for n, s, e in inside if n in ("ipm.evals", "ipm.step")]
    ns = sum((e - s) - union_ns([(a, b) for a, b in work
                                 if a >= s and b <= e])
             for s, e in calls)
    return ns / 1e6 / len(ctx.traced)
