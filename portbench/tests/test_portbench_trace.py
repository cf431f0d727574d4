"""The trace reduction on a synthetic trace: interval union, range self
time, idle gaps by host range, band-kernel selection."""
from portbench.harness.trace import (CALL_SPAN, Trace, merged, union_ns)


def test_union_and_merge():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41), (12, 13)]
    assert union_ns(iv) == 15 + 11 + 1
    assert merged(iv) == [(0, 15), (20, 31), (40, 41)]
    assert union_ns([]) == 0


def _trace():
    ranges = [(CALL_SPAN, 0, 100), ("ipm.evals", 5, 20),
              ("ipm.step", 20, 90), ("kkt.prepare", 25, 60),
              ("kkt.solve", 60, 80), ("kkt.solve", 95, 99),
              (CALL_SPAN, 110, 150), ("ipm.step", 115, 140),
              ("kkt.prepare", 118, 130)]
    ops = [("k_a", 6, 10), ("band_qr_kernel<float, 13>", 30, 40),
           ("k_a", 35, 50), ("Memcpy HtoD", 70, 72),
           ("band_qr_kernel<float, 13>", 120, 125), ("k_b", 145, 160),
           ("k_early", -10, 2)]
    return Trace(ops, ranges)


def test_window_busy_and_kernels():
    t = _trace()
    assert t.window == (0, 150)
    # clipped to the window: (0,2) (6,10) (30,50) (70,72) (120,125) (145,150)
    assert t.busy_ns() == 2 + 4 + 20 + 2 + 5 + 5
    assert [op[0] for op in t.kernels()].count("Memcpy HtoD") == 0
    assert len(t.kernels()) == 6
    assert len(t.band_kernels()) == 2


def test_range_and_self_time():
    t = _trace()
    assert t.range_ns({"kkt.prepare"}) == 35 + 12
    assert t.range_ns({"kkt.solve"}) == 20 + 4
    outer = {"ipm.evals", "ipm.step"}
    inner = {"kkt.prepare", "kkt.solve"}
    # outer 15 + 70 + 25; inner inside outer 35 + 20 + 12 (the kkt.solve at
    # 95-99 lies outside every outer range)
    assert t.self_ns(outer, inner) == 110 - 67


def test_idle_gaps_named_by_innermost_range():
    t = _trace()
    gaps = dict(t.idle_gaps())
    # gaps: (2,6): mid 4, before ipm.evals opens -> the call span;
    # (10,30): mid 20, ipm.evals has closed, ipm.step opens; (50,70): mid
    # 60 -> kkt.solve; (72,120): mid 96 -> the kkt.solve at 95-99;
    # (125,145): mid 135 -> ipm.step
    assert gaps == {CALL_SPAN: 4e-9, "ipm.step": 40e-9,
                    "kkt.solve": 68e-9}
    top = t.top_device_ops(2)
    assert top[0] == ["k_a", 19e-9]
