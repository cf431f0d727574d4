"""device_idle_pct: the share of the traced window in which no operation
ran on the card, 100 * (1 - union of the device operations' intervals /
window)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
