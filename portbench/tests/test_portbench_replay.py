"""``oracle_replay_pct`` on a synthetic trace: the ``oracle.replay`` spans
of the traced window over its ``oracle.point`` spans, 0 where none
replays (a program without the graphs), None without point evaluations."""
from types import SimpleNamespace

import pytest

from portbench.harness import registry
from portbench.harness.trace import CALL_SPAN, Trace


def _ctx(ranges):
    return SimpleNamespace(trace=Trace([("k_a", 0, 5)], ranges),
                           traced=[dict(steps=1)], calls=[dict(steps=1)])


def test_replay_share_counts_the_window_only():
    read = registry.reader("oracle_replay_pct")
    ranges = [
        # before the window: replays that must not count
        ("oracle.point", -50, -40), ("oracle.replay", -49, -41),
        ("oracle.point", -30, -20), ("oracle.replay", -29, -21),
        (CALL_SPAN, 0, 100),
        ("oracle.point", 10, 20),                            # eager
        ("oracle.point", 30, 40), ("oracle.replay", 31, 39),
        ("oracle.point", 50, 60), ("oracle.replay", 51, 59),
        ("oracle.point", 70, 80), ("oracle.replay", 71, 79)]
    assert read(_ctx(ranges)) == pytest.approx(75.0, rel=1e-12)
    eager = [r for r in ranges if r[0] != "oracle.replay"]
    assert read(_ctx(eager)) == 0.0
    assert read(_ctx([r for r in ranges if r[0] == CALL_SPAN])) is None
    ctx = _ctx(ranges)
    ctx.trace = None
    assert read(ctx) is None
