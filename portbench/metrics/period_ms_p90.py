"""period_ms_p90: the 90th percentile, over every call of the window, of
one period's wall time: from handing the fleet's states over to every u0
on the host (host clock)."""
import numpy as np


def read(ctx):
    ms = [(c["t1"] - c["t0"]) * 1e3 for c in ctx.calls]
    return float(np.percentile(ms, 90))
