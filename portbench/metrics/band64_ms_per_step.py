"""band64_ms_per_step: device time per Newton step of the band kernel
launches whose recorded item size is 8 (float64: every sweep of the
float64 BBD solve, its refinement's second sweep included), in the traced
calls.  None where no such launch was traced, or when the launches
recorded and the events traced differ in number."""
from portbench.harness.launches import band_launches


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    pairs = band_launches(ctx, itemsize=8)
    if not steps or not pairs:
        return None
    return sum(ns for _, ns in pairs) / 1e6 / steps
