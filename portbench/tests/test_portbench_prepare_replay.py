"""``prepare_replay_pct`` on a synthetic trace: the ``oracle.hessian``
spans of the traced window that hold a ``kkt.replay`` span, over all of
them; 0 where none replays (a program whose derivative oracles run
eagerly), None without Hessian spans."""
from types import SimpleNamespace

import pytest

from portbench.harness import registry
from portbench.harness.trace import CALL_SPAN, Trace


def _ctx(ranges):
    return SimpleNamespace(trace=Trace([("k_a", 0, 5)], ranges),
                           traced=[dict(steps=1)], calls=[dict(steps=1)])


def test_prepare_replay_share_counts_the_window_only():
    read = registry.reader("prepare_replay_pct")
    ranges = [
        # before the window: replays that must not count
        ("oracle.hessian", -50, -40), ("kkt.replay", -49, -41),
        (CALL_SPAN, 0, 100),
        ("oracle.gather", 5, 9), ("kkt.replay", 6, 8),
        ("oracle.hessian", 10, 20),                          # eager
        ("oracle.jacobian", 21, 25), ("kkt.replay", 22, 24),
        ("oracle.hessian", 30, 40), ("kkt.replay", 31, 39),
        ("oracle.hessian", 50, 60), ("kkt.replay", 51, 59),
        ("oracle.hessian", 70, 80), ("kkt.replay", 71, 79)]
    assert read(_ctx(ranges)) == pytest.approx(75.0, rel=1e-12)
    eager = [r for r in ranges if r[0] != "kkt.replay"]
    assert read(_ctx(eager)) == 0.0
    assert read(_ctx([r for r in ranges
                      if not r[0].startswith("oracle.")])) is None
    ctx = _ctx(ranges)
    ctx.trace = None
    assert read(ctx) is None
