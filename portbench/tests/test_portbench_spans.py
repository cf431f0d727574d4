"""The readers of the program's spans (``batch.solve``, ``oracle.*``,
``kkt.condense``, ``ipm.line_search``, ``sync.*``) on a synthetic trace:
each counts the spans inside the traced window only, and reads None where
the program opens no such span."""
from types import SimpleNamespace

import pytest

from portbench.harness import registry
from portbench.harness.trace import CALL_SPAN, Trace


def _span_ctx():
    """Two traced calls (1 + 2 Newton steps) and, before the window, a
    stray call whose spans every reader must ignore."""
    ranges = [
        # outside the window: a batch.solve with every span in it
        ("batch.solve", -100, -10), ("ipm.evals", -95, -90),
        ("oracle.point", -94, -92), ("ipm.step", -90, -20),
        ("oracle.hessian", -80, -70), ("oracle.jacobian", -70, -65),
        ("kkt.condense", -60, -50), ("ipm.line_search", -40, -30),
        ("sync.loop", -29, -28),
        # call 1: one Newton step
        (CALL_SPAN, 0, 100), ("batch.solve", 2, 98),
        ("sync.x0", 3, 4), ("ipm.init", 5, 10), ("oracle.point", 6, 8),
        ("sync.loop", 10, 12), ("ipm.evals", 12, 20),
        ("oracle.point", 13, 17), ("sync.live", 20, 23),
        ("ipm.step", 23, 80), ("kkt.prepare", 25, 45),
        ("oracle.gather", 25, 27), ("oracle.hessian", 27, 39),
        ("oracle.jacobian", 39, 44), ("kkt.solve", 45, 60),
        ("kkt.condense", 46, 53), ("ipm.line_search", 62, 79),
        ("oracle.point", 63, 66), ("sync.line_search", 70, 71),
        ("sync.loop", 80, 81), ("ipm.finish", 82, 95),
        # call 2: two Newton steps
        (CALL_SPAN, 110, 200), ("batch.solve", 111, 199),
        ("ipm.evals", 120, 130), ("ipm.step", 130, 150),
        ("oracle.hessian", 131, 141), ("kkt.condense", 142, 144),
        ("ipm.line_search", 145, 149), ("ipm.evals", 150, 160),
        ("ipm.step", 160, 190), ("oracle.hessian", 161, 171),
        ("oracle.jacobian", 171, 175), ("kkt.condense", 176, 177),
        ("kkt.condense", 178, 180), ("ipm.line_search", 181, 189),
        ("sync.loop", 190, 194)]
    trace = Trace([("k_a", 0, 5)], ranges)
    assert trace.window == (0, 200)
    calls = [dict(steps=1), dict(steps=2)]
    return SimpleNamespace(trace=trace, traced=calls, calls=calls)


@pytest.mark.parametrize("name,expected", [
    # batch.solve 96 + 88 less ipm.evals/step inside: (8 + 57), (10 + 20 +
    # 10 + 30): 31 + 18 ns over 2 calls
    ("call_overhead_ms_per_call", (31 + 18) / 2 / 1e6),
    ("oracle_point_ms_per_step", (2 + 4 + 3) / 3 / 1e6),
    ("hessian_ms_per_step", (12 + 10 + 10) / 3 / 1e6),
    ("jacobian_ms_per_step", (5 + 4) / 3 / 1e6),
    ("condense_ms_per_step", (7 + 2 + 1 + 2) / 3 / 1e6),
    ("line_search_ms_per_step", (17 + 4 + 8) / 3 / 1e6),
    ("host_syncs_per_step", 6 / 3),
    ("sync_wait_ms_per_step", (1 + 2 + 3 + 1 + 1 + 4) / 3 / 1e6),
])
def test_span_readers_count_the_window_only(name, expected):
    read = registry.reader(name)
    ctx = _span_ctx()
    assert read(ctx) == pytest.approx(expected, rel=1e-12)
    # a trace without the program's spans (the parent's) reads None
    bare = Trace([("k_a", 0, 5)], [r for r in ctx.trace.ranges
                                   if r[0] == CALL_SPAN])
    ctx.trace = bare
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None
