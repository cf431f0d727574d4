"""band_ms_per_step: device time of the band kernels' events per Newton
step, in the traced calls."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    band = ctx.trace.band_kernels()
    if not band:
        return None
    return sum(e - s for _, s, e in band) / 1e6 / steps
