"""The yardstick's table of peaks and the band sweep's work model.

``band_work`` is a frozen copy of the program's ``chip_smoke.band_work``:
the bytes the sweep must move (inputs read once, the solution written
once) and the floating-point operations of the blocked Householder sweep
over a chain of S stages, b wide, with t right-hand sides.

One peak serves every dtype the band kernels run in: 67 TFLOP/s is the
highest rate an H100 SXM reaches at float32 precision or above (float32
on the CUDA cores, float64 on the tensor cores; NVIDIA's data sheet,
dense), so the same work reads the same share whichever kernel does it.
"""

PEAK_FLOPS = 67e12          # H100 SXM, float32 (CUDA cores) / float64 TC
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s


def band_work(N, S, b, t, itemsize):
    """(bytes, flops) of one sweep of N chains."""
    n_el = N * (S * b * b + 2 * (S - 1) * b * b + 2 * S * b * t)
    n_p = 3 * b + t

    def elim(m):
        return sum(4 * (m - j) * (n_p - j) + 3 * (m - j) for j in range(b))

    per_chain = (S - 1) * elim(2 * b) + elim(b) \
        + S * b * b * t + (S - 1) * 4 * b * b * t
    return n_el * itemsize, N * per_chain


def band_bound_s(N, S, b, t, itemsize):
    """The least time the card could take for the sweep: the larger of
    its bytes over the bandwidth and its operations over the peak."""
    nbytes, flops = band_work(N, S, b, t, itemsize)
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)
