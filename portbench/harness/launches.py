"""The band kernels' launches of the traced window, each paired with the
chain shape and item size the harness recorded for it
(:class:`portbench.harness.trace.BandRecorder`).  The kernels run on one
stream in the order they were launched, so the i-th traced event in time
is the i-th recorded launch."""


def band_launches(ctx, itemsize=None):
    """[((N, S, b, t, itemsize), device_ns), ...] of the traced band
    kernels, those of ``itemsize`` only if given; None without a trace or
    when the launches recorded and the events traced differ in number."""
    if ctx.trace is None:
        return None
    events = sorted(ctx.trace.band_kernels(), key=lambda ev: ev[1])
    if len(events) != len(ctx.band_shapes):
        return None
    return [(shape, e - s) for shape, (_, s, e) in zip(ctx.band_shapes,
                                                       events)
            if itemsize is None or shape[4] == itemsize]
