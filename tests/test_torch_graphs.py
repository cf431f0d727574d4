"""The policy of the IPM's graph cache (``solver/_graphs.py``) on the CPU:
every point evaluation of a solve is eager there, and with a capture
function injected in place of the CUDA graph capture a key captures on its
second sight, replays from its third, falls back to eager for good when
its capture fails, never hands out a tensor that a later replay
overwrites, and stays eager while autograd records or ``torch.func``
transforms; one solver serves every bound set of its dynamic-bounds calls
through its one cache.  The derivative oracles of ``kkt.prepare`` go
through the same policy, count in ``prepare_graph`` and replay in span
``kkt.replay``; every way to build a solver (``Optimizer._make_solver``)
gives the solver and its structured backend one cache.  The replays on the
card: ``tests/test_torch_cuda.py``."""
import contextlib
import gc

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from dompc_tpu_torch import optimizer as optimizer_mod
from dompc_tpu_torch.parallel import batch as batch_mod
from dompc_tpu_torch.solver import ipm as ipm_mod
from dompc_tpu_torch.solver._graphs import GraphCache, _Graph
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


@pytest.mark.parametrize("fail", [False, True])
def test_capture_runs_with_the_collector_paused(fail):
    """A collection inside a capture would destroy the graphs of solvers no
    longer referenced, which CUDA forbids while a stream captures: the
    capture runs with the garbage collector paused, and the collector's
    state is restored after it, whether the capture succeeds or fails."""
    seen = []
    capture = _fake_capture([], fail=fail)

    def recording(fn, static_args):
        seen.append(gc.isenabled())
        return capture(fn, static_args)
    x, y = torch.rand(3, 2), torch.rand(3, 2)
    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            cache = GraphCache(capture=recording, device_type="cpu")
            for _ in range(3):
                cache(_fn, (x, y))
            assert gc.isenabled() is enabled
        finally:
            gc.enable()
    assert seen == [False, False]


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
    """One solver serves every bound set: its dynamic-bounds calls evaluate
    through its one cache, so the first call captures each key once, the
    later calls capture nothing and replay every evaluation, and each call
    answers as a solver whose evaluations are bare, in as many Newton
    steps."""
    made = []

    def cache():
        made.append(GraphCache(capture=_fake_capture([]), device_type="cpu"))
        return made[-1]
    w0 = torch.zeros((3, 2), dtype=torch.float64)
    lbs = [torch.full((3, 2), -10.0, dtype=torch.float64) + k
           for k in (0.0, 9.5, 0.0)]
    ubs = [torch.full((3, 2), 10.0, dtype=torch.float64) - k
           for k in (0.0, 8.5, 9.0)]
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
    keys = made[0]._keys
    assert deltas[0]["captures"] > 3 and deltas[0]["failures"] == 0
    assert sum(d["captures"] for d in deltas) == deltas[0]["captures"] \
        == sum(isinstance(v, _Graph) for v in keys.values())
    for d in deltas[1:]:
        assert d["captures"] == d["eager"] == d["failures"] == 0
        assert d["replays"] > 10
    assert sol.newton_steps == bare.newton_steps > 0
    for a, b in zip(got, want):
        assert bool(a.success.all()) and bool(b.success.all())
        assert torch.equal(a.iterations, b.iterations)
        torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)
    # the bounds move the solution: the calls did not share answers
    assert float((got[0].w - got[1].w).abs().max()) > 1e-3
    assert float((got[0].w - got[2].w).abs().max()) > 1e-3


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
    prepare, _ = mpc._make_kkt_backend("condensed", 1e-8, 1, GraphCache(
        capture=_fake_capture([]), device_type="cpu"))
    bare, _ = mpc._make_kkt_backend("condensed", 1e-8, 1, GraphCache())
    pvec = _pvecs(mpc, np.zeros((2, mpc.model.n_x)))
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


def _pvecs(mpc, x0s):
    """The batched entry's parameter vectors of the states ``x0s``."""
    pvec = mpc._tensor(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)))
    pvec = pvec.expand(len(x0s), -1).clone()
    pvec[:, mpc._p_sl["x0"]] = mpc._tensor(x0s)
    return pvec


def _mpc_setup(cstr, monkeypatch):
    """``MPC._create_solver``, which ``MPC.setup`` calls: the controller's
    own solver (full-featured, at tolerance 1e-3) on the cold batch."""
    mpc, x0s, w0, _ = cstr
    monkeypatch.setattr(mpc.settings, "solver_tol", 1e-3)
    mpc._create_solver()
    solve = mpc._solve_raw
    return solve, lambda: solve(mpc._tensor(w0), _pvecs(mpc, x0s))


def _batch_entry(cstr, monkeypatch):
    """``make_batch_solver`` in throughput mode, one cold call."""
    mpc, x0s, w0, _ = cstr
    solve = batch_mod.make_batch_solver(mpc, tol=1e-3, max_iter=60,
                                        throughput_mode=True)
    return solve.ipm, lambda: solve(x0s, w0)[0]


def _branch_and_bound(cstr, monkeypatch):
    """``BranchAndBound``: one frontier expansion of two nodes below the
    cold batch's first solution, under the root's bounds and with the
    first feed rate's lower bound raised to the middle of its box."""
    from dompc_tpu_torch.solver.minlp import BranchAndBound
    mpc, x0s, _, root = cstr
    idx = mpc.layout.idx(("u", 0, 0))
    bnb = BranchAndBound(mpc, idx, np.ones(len(idx)), tol=1e-3, max_iter=60)
    lb, ub = bnb._lb0, bnb._ub0
    lbs, ubs = np.stack([lb, lb]), np.stack([ub, ub])
    lbs[1, idx[0]] = 0.5 * (lb[idx[0]] + ub[idx[0]])

    def row(x):
        return x[0].numpy()
    return bnb._solve, lambda: bnb._node_solve(
        row(root.w), _pvecs(mpc, x0s)[0].numpy(), row(root.lam),
        row(root.zl), row(root.zu), lbs, ubs)


def _mhe_setup(cstr, monkeypatch):
    """``MHE._create_solver``, which ``MHE.setup`` calls: a damped
    oscillator's stiffness estimated over N = 3 on the bordered band, one
    step."""
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch import sym
    model = tdm.model.Model("continuous")
    x = model.set_variable("_x", "x", shape=(2, 1))
    u = model.set_variable("_u", "u")
    k = model.set_variable("_p", "k")
    model.set_meas("x_meas", x[0])
    model.set_meas("u_meas", u)
    model.set_rhs("x", sym.vertcat(x[1], -k * x[0] - 0.1 * x[1] + u))
    model.setup()
    mhe = tdm.estimator.MHE(model, ["k"])
    mhe.settings.n_horizon = 3
    mhe.settings.t_step = 0.1
    mhe.settings.kkt_solver = "tridiag"
    mhe.set_default_objective(np.eye(2), np.diag([1.0, 10.0]),
                              np.array([[1.0]]))
    mhe.bounds["lower", "_x", "x"] = -5
    mhe.bounds["upper", "_x", "x"] = 5
    mhe.set_nl_cons("k_lb", -mhe._p_est["k"] + 0.1, 0)
    mhe.setup()
    mhe.x0 = np.array([0.5, 0.0])
    mhe.p_est0 = 1.0
    mhe.set_initial_guess()

    def step():
        mhe.make_step(np.array([[0.45], [0.2]]))
        return ipm_mod.IPMSolution(*(None,) * 9)._replace(
            w=torch.as_tensor(mhe.opt_x_num)[None],
            iterations=torch.tensor([mhe.solver_stats["iter_count"]]),
            success=torch.tensor([mhe.solver_stats["success"]]))
    return mhe._solve_raw, step


@pytest.mark.parametrize("build", [_mpc_setup, _batch_entry,
                                   _branch_and_bound, _mhe_setup],
                         ids=["MPC.setup", "make_batch_solver",
                              "BranchAndBound", "MHE.setup"])
def test_solver_and_backend_evaluate_through_one_cache(cstr_cpu, build,
                                                       monkeypatch):
    """Every way to build a solver (``Optimizer._make_solver``) makes one
    cache, the solver's ``graphs``, and its structured backend evaluates
    the three prepare keys there: a cold call captures the point
    evaluations and the prepare keys in it, counts each kind apart (every
    ``oracle.point`` in ``oracle_graph``, three evaluations a
    ``kkt.prepare`` in ``prepare_graph``) and answers as the bare solver
    does.  The MHE's backend evaluates its derivatives eagerly, outside
    the cache."""
    want = build(cstr_cpu, monkeypatch)[1]()
    made = []

    def cache():
        made.append(GraphCache(capture=_fake_capture([]), device_type="cpu"))
        return made[-1]
    for mod in (optimizer_mod, ipm_mod):
        monkeypatch.setattr(mod, "GraphCache", cache)
    solver, run = build(cstr_cpu, monkeypatch)
    log = _span_log(monkeypatch)
    before, before_point = _counts("prepare_graph"), _counts()
    got = run()
    prepares = sum(1 for name, _ in log if name == "kkt.prepare")
    points = sum(1 for name, _ in log if name == "oracle.point")
    assert len(made) == 1 and solver.graphs is made[0]
    assert prepares > 3
    replays = 0 if build is _mhe_setup else 3 * (prepares - 2)
    assert _delta(before, "prepare_graph") == (
        dict(captures=0, replays=0, eager=0, failures=0)
        if build is _mhe_setup
        else dict(captures=3, replays=replays, eager=3, failures=0))
    point = _delta(before_point)
    assert point["failures"] == 0 and point["captures"] >= 3
    assert sum(point.values()) == points
    assert sum(1 for name, _ in log if name == "kkt.replay") == replays
    assert bool(got.success.all())
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.success, want.success)
    torch.testing.assert_close(got.w, want.w, rtol=0, atol=0)
