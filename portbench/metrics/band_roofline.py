"""band_roofline: the band kernels' share of their roofline in the
traced calls, 100 * (sum of each launch's bound) / (sum of the band
kernels' device time).  A launch's bound is the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, from the chain shape the
harness recorded at the launch (``portbench.harness.work``).  Nothing is
read when the launches recorded and the kernel events traced differ in
number."""
from portbench.harness.work import band_bound_s


def read(ctx):
    if ctx.trace is None:
        return None
    band = ctx.trace.band_kernels()
    if not band or len(band) != len(ctx.band_shapes):
        return None
    bound_s = sum(band_bound_s(*shape) for shape in ctx.band_shapes)
    device_s = sum(e - s for _, s, e in band) / 1e9
    return 100.0 * bound_s / device_s
