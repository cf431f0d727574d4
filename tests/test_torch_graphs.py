"""The policy of the IPM's graph cache (``solver/_graphs.py``) on the CPU:
every point evaluation of a solve is eager there, and with a capture
function injected in place of the CUDA graph capture a key captures on its
second sight, replays from its third, falls back to eager for good when
its capture fails, never hands out a tensor that a later replay
overwrites, and stays eager while autograd records or ``torch.func``
transforms; a solver's dynamic-bounds calls share its cache and its
graphs.  The derivative oracles of ``kkt.prepare`` go through the same
policy, count in ``prepare_graph`` and replay in span ``kkt.replay``.  The
replays on the card: ``tests/test_torch_cuda.py``."""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from dompc_tpu_torch.parallel import batch as batch_mod
from dompc_tpu_torch.solver import ipm as ipm_mod
from dompc_tpu_torch.solver._graphs import GraphCache
from dompc_tpu_torch.tools import _profiler as profiler


def _counts(group="oracle_graph"):
    c = getattr(profiler, group)
    return dict(captures=c.captures, replays=c.replays, eager=c.eager,
                failures=c.failures)


def _delta(before, group="oracle_graph"):
    return {k: v - before[k] for k, v in _counts(group).items()}


def _fake_capture(log, fail=False):
    """A capture that records what it captured: its outputs hold NaN until
    a replay recomputes them from the static inputs in place, as a graph's
    do before their first replay."""
    def capture(fn, static_args):
        log.append(fn)
        if fail:
            raise RuntimeError("operation not permitted when capturing")
        out = fn(*static_args)
        for x in pytree.tree_leaves(out):
            x.fill_(float("nan"))

        def replay():
            for dst, src in zip(pytree.tree_leaves(out),
                                pytree.tree_leaves(fn(*static_args))):
                dst.copy_(src)
        return replay, out
    return capture


def _fn(x, y):
    return x * y, (x + y).sum(-1)


def _toy_solver(**kw):
    return ipm_mod.make_ipm_solver(
        lambda w, p: ((w - p) ** 2).sum(-1),
        lambda w, p: w[:, :1] + w[:, 1:2] - 1.0,
        lambda w, p: w[:, :1] ** 2 - 4.0,
        np.full(2, -10.0), np.full(2, 10.0), 1, 1,
        settings=ipm_mod.IPMSettings(tol=1e-8), dtype=torch.float64,
        device="cpu", **kw)


_P = torch.tensor([[0.0, 0.0], [1.0, 2.0], [3.0, -1.0]], dtype=torch.float64)


def test_solve_on_cpu_evaluates_every_point_eagerly(monkeypatch):
    spans = []
    real_span = profiler.span

    def span(name):
        spans.append(name)
        return real_span(name)
    monkeypatch.setattr(profiler, "span", span)
    sol = _toy_solver()
    before = _counts()
    out = sol(torch.zeros((3, 2), dtype=torch.float64), _P)
    got = _delta(before)
    assert bool(out.success.all())
    n_points = spans.count("oracle.point")
    assert n_points > 10 and "oracle.replay" not in spans
    assert got == dict(captures=0, replays=0, eager=n_points, failures=0)


def test_key_captures_on_second_sight_and_replays_from_third():
    log = []
    cache = GraphCache(capture=_fake_capture(log), device_type="cpu")
    x, y = torch.rand(4, 3), torch.rand(4, 3)
    before = _counts()
    outs = [cache(_fn, (x + k, y)) for k in range(4)]
    got = _delta(before)
    assert got == dict(captures=1, replays=2, eager=1, failures=0)
    assert log == [_fn]
    for k, (a, b) in enumerate(outs):
        ra, rb = _fn(x + k, y)
        torch.testing.assert_close(a, ra, rtol=0, atol=0)
        torch.testing.assert_close(b, rb, rtol=0, atol=0)
    # another shape is another key: eager at its first sight
    cache(_fn, (torch.rand(2, 3), torch.rand(2, 3)))
    assert _delta(before)["eager"] == 2 and log == [_fn]


def test_failing_capture_stays_eager_for_good():
    log = []
    cache = GraphCache(capture=_fake_capture(log, fail=True),
                       device_type="cpu")
    x, y = torch.rand(5, 2), torch.rand(5, 2)
    before = _counts()
    outs = [cache(_fn, (x, y * k)) for k in range(5)]
    assert _delta(before) == dict(captures=0, replays=0, eager=5,
                                  failures=1)
    assert log == [_fn]
    torch.testing.assert_close(outs[3][0], x * (y * 3), rtol=0, atol=0)


def test_replays_never_alias_a_result_held_by_the_caller():
    cache = GraphCache(capture=_fake_capture([]), device_type="cpu")
    x, y = torch.rand(3, 4), torch.rand(3, 4)
    cache(_fn, (x, y))                      # eager
    first = cache(_fn, (x, y))              # capture + replay
    kept = [t.clone() for t in first]
    second = cache(_fn, (x + 1.0, y - 2.0))  # replay at another point
    third = cache(_fn, (x * 3.0, y))         # and another
    for held, copy in zip(first, kept):
        torch.testing.assert_close(held, copy, rtol=0, atol=0)
    for a, b in zip(second + third, first + first):
        assert a.data_ptr() != b.data_ptr()
    torch.testing.assert_close(second[0], (x + 1.0) * (y - 2.0))


def test_autograd_and_torch_func_stay_eager():
    log = []
    cache = GraphCache(capture=_fake_capture(log), device_type="cpu")
    x = torch.rand(3, 2, requires_grad=True)
    y = torch.rand(3, 2)
    before = _counts()
    for _ in range(3):
        a, b = cache(_fn, (x, y))
    (a.sum() + b.sum()).backward()
    torch.testing.assert_close(x.grad, y + 1.0)
    with torch.no_grad():                   # no recording: a key again
        for _ in range(3):
            cache(_fn, (x, y))
    for _ in range(3):                      # under a transform: eager
        torch.func.vmap(lambda r: cache(_fn, (r, r))[1])(y)
    assert _delta(before) == dict(captures=1, replays=1, eager=7,
                                  failures=0)
    assert log == [_fn]


def test_dynamic_bounds_calls_share_the_solvers_graphs(monkeypatch):
    """Each dynamic-bounds call builds a solver of its own over the call's
    bounds; it evaluates the functions of the solver that made it through
    that solver's cache, so the second call captures nothing, replays every
    evaluation, and answers as the bare evaluations do."""
    made = []

    def cache():
        made.append(GraphCache(capture=_fake_capture([]), device_type="cpu"))
        return made[-1]
    w0 = torch.zeros((3, 2), dtype=torch.float64)
    lbs = [torch.full((3, 2), -10.0, dtype=torch.float64) + k
           for k in (0.0, 9.5)]
    ubs = [torch.full((3, 2), 10.0, dtype=torch.float64) - k
           for k in (0.0, 8.5)]
    bare = _toy_solver(dynamic_bounds=True)
    want = [bare(w0, _P, lb_dyn=lb, ub_dyn=ub) for lb, ub in zip(lbs, ubs)]
    monkeypatch.setattr(ipm_mod, "GraphCache", cache)
    sol = _toy_solver(dynamic_bounds=True)
    got, deltas = [], []
    for lb, ub in zip(lbs, ubs):
        before = _counts()
        got.append(sol(w0, _P, lb_dyn=lb, ub_dyn=ub))
        deltas.append(_delta(before))
    assert len(made) == 1 and sol.graphs is made[0]
    assert len(made[0].functions) == 9
    assert deltas[0]["captures"] > 3 and deltas[0]["failures"] == 0
    assert deltas[1]["captures"] == deltas[1]["eager"] == 0
    assert deltas[1]["replays"] > 10
    for a, b in zip(got, want):
        assert bool(a.success.all()) and bool(b.success.all())
        assert torch.equal(a.iterations, b.iterations)
        torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)
    # the second bounds move the solution: the calls did not share answers
    assert float((got[0].w - got[1].w).abs().max()) > 1e-3


# -- the derivative oracles of kkt.prepare (controller/_mpc.py) --------------

@pytest.fixture(scope="module")
def cstr_cpu():
    """The robust CSTR at N = 4 in float64 on the CPU, B = 2 states, and a
    cold call's answers by a batched solver whose evaluations are bare."""
    from dompc_tpu_torch.parallel import initial_guess_from_x0
    from dompc_tpu_torch.systems import bench_states, cstr_robust_mpc
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        mpc = cstr_robust_mpc(n_horizon=4, n_robust=1)
        x0s = bench_states(2)
        w0 = initial_guess_from_x0(mpc, x0s)
        bare = batch_mod.make_batch_solver(mpc, tol=1e-3, max_iter=60,
                                           throughput_mode=True)
        yield mpc, x0s, w0, bare(x0s, w0)[0]
    torch.set_num_threads(threads)


def _span_log(monkeypatch):
    """Record every span opened as (name, the span it opens inside)."""
    log, stack = [], []

    @contextlib.contextmanager
    def span(name):
        log.append((name, stack[-1] if stack else None))
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()
    monkeypatch.setattr(profiler, "span", span)
    return log


def test_prepare_oracles_capture_on_second_sight_and_replay_after(
        cstr_cpu, monkeypatch):
    """The gather, Hessians and Jacobians of prepare are three keys: eager
    at the first prepare, captured at the second, replayed after, each in
    its own ``oracle.*`` span with ``kkt.replay`` inside, equal to the bare
    prepare's; they count in ``prepare_graph`` and not in
    ``oracle_graph``."""
    mpc, _, _, sol = cstr_cpu
    m = mpc.n_opt_lagr
    prepare, _ = mpc._make_kkt_backend(1e-8, graphs=GraphCache(
        capture=_fake_capture([]), device_type="cpu"))
    bare, _ = mpc._make_kkt_backend(1e-8)
    pvec = torch.as_tensor(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)),
                           dtype=mpc._dtype).expand(2, -1).clone()
    sig = torch.ones_like(sol.w)
    points = [(sol.w * (1 + 1e-2 * k), sol.lam * (1 - 0.1 * k))
              for k in range(4)]
    log = _span_log(monkeypatch)
    before, before_point = _counts("prepare_graph"), _counts()
    outs, logs = [], []
    for w, lam in points:
        del log[:]
        outs.append(prepare(w, pvec, lam[:, :m], lam[:, m:], sig,
                            sig[:, :0]))
        logs.append(list(log))
    assert _delta(before, "prepare_graph") == dict(captures=3, replays=6,
                                                   eager=3, failures=0)
    assert _delta(before_point) == dict(captures=0, replays=0, eager=0,
                                        failures=0)
    eager = [("oracle.gather", None), ("oracle.hessian", None),
             ("oracle.jacobian", None)]
    replayed = [x for name, _ in eager
                for x in ((name, None), ("kkt.replay", name))]
    assert logs == [eager, eager, replayed, replayed]
    for (w, lam), out in zip(points, outs):
        want = bare(w, pvec, lam[:, :m], lam[:, m:], sig, sig[:, :0])
        assert len(out) == len(want) == 5
        for a, b in zip(out[:3], want[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the points differ, so the replays did not hand back stale answers
    assert float((outs[3][0] - outs[2][0]).abs().max()) > 1e-6


def test_solver_and_backend_evaluate_through_one_cache(cstr_cpu,
                                                       monkeypatch):
    """The batched entry hands one cache to its solver and its structured
    backend: a cold call captures the point evaluations and the three
    prepare keys there, counts each kind apart (every ``oracle.point`` in
    ``oracle_graph``, three evaluations a ``kkt.prepare`` in
    ``prepare_graph``) and answers as the bare solver does."""
    mpc, x0s, w0, want = cstr_cpu
    made = []

    def cache():
        made.append(GraphCache(capture=_fake_capture([]), device_type="cpu"))
        return made[-1]
    monkeypatch.setattr(batch_mod, "GraphCache", cache)
    solve = batch_mod.make_batch_solver(mpc, tol=1e-3, max_iter=60,
                                        throughput_mode=True)
    log = _span_log(monkeypatch)
    before, before_point = _counts("prepare_graph"), _counts()
    got, _ = solve(x0s, w0)
    prepares = sum(1 for name, _ in log if name == "kkt.prepare")
    points = sum(1 for name, _ in log if name == "oracle.point")
    assert len(made) == 1 and solve.ipm.graphs is made[0]
    assert prepares > 3
    assert _delta(before, "prepare_graph") == dict(
        captures=3, replays=3 * (prepares - 2), eager=3, failures=0)
    point = _delta(before_point)
    assert point["failures"] == 0 and point["captures"] >= 3
    assert sum(point.values()) == points
    assert sum(1 for name, _ in log if name == "kkt.replay") \
        == 3 * (prepares - 2)
    assert bool(got.success.all())
    assert torch.equal(got.iterations, want.iterations)
    torch.testing.assert_close(got.w, want.w, rtol=0, atol=0)
