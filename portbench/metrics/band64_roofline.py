"""band64_roofline: the float64 band kernels' share of their roofline in
the traced calls, 100 * (sum of each launch's bound) / (sum of their
device time), over the launches whose recorded item size is 8.  A launch's
bound is the larger of its bytes over 3.35 TB/s and its operations over
67 TFLOP/s (``portbench.harness.work``).  Nothing is read when the
launches recorded and the kernel events traced differ in number."""
from portbench.harness.launches import band_launches
from portbench.harness.work import band_bound_s


def read(ctx):
    pairs = band_launches(ctx, itemsize=8)
    if not pairs:
        return None
    device_s = sum(ns for _, ns in pairs) / 1e9
    return 100.0 * sum(band_bound_s(*shape) for shape, _ in pairs) / device_s
