"""``tools.profiler`` of the PyTorch port (CPU): the annotations are no-ops
without a trace, ``trace`` around a ``make_step`` writes a Chrome/Perfetto
JSON holding the solve's range, and the error cases raise (cf. the JAX
package's tests/test_profiler.py); the spans inside a batched solve nest as
the layers do, and ``span`` is one shared no-op without a profiler."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import dompc_tpu_torch as dm
from dompc_tpu_torch.tools import profiler


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _toy_mpc():
    """tests/test_profiler.py:test_solve_is_annotated's MPC."""
    model = dm.model.Model("continuous")
    x = model.set_variable("_x", "x")
    u = model.set_variable("_u", "u")
    model.set_rhs("x", -x + u)
    model.setup()
    mpc = dm.controller.MPC(model)
    mpc.settings.n_horizon = 3
    mpc.settings.t_step = 0.5
    mpc.set_objective(mterm=x ** 2, lterm=x ** 2)
    mpc.set_rterm(u=0.01)
    mpc.setup()
    mpc.x0 = np.array([1.0])
    mpc.set_initial_guess()
    return mpc


def test_annotations_are_noops_without_trace():
    with profiler.annotate("unit-region"):
        with profiler.step_annotation("unit-step", 3):
            pass


def test_trace_holds_the_solve_range(tmp_path):
    mpc = _toy_mpc()
    logdir = tmp_path / "trace"
    with profiler.trace(str(logdir), create_perfetto_trace=True):
        u0 = mpc.make_step(np.array([1.0]))
    assert np.all(np.isfinite(u0)) and mpc._n_solves == 1
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "dompc_tpu_torch.MPC.solve/1" in names


def test_trace_errors(tmp_path):
    with pytest.raises(RuntimeError):
        profiler.stop_trace()
    with pytest.raises(ValueError):
        profiler.start_trace(str(tmp_path), create_perfetto_link=True)
    profiler.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError):
            profiler.start_trace(str(tmp_path))
    finally:
        path = profiler.stop_trace()
    assert os.path.isfile(path)
    with pytest.raises(RuntimeError):
        profiler.stop_trace()


def test_device_memory_profile_raises_on_cpu(tmp_path):
    with pytest.raises(RuntimeError):
        profiler.save_device_memory_profile(str(tmp_path / "mem.pkl"))
    assert not (tmp_path / "mem.pkl").exists()


# -- the spans inside the solve ----------------------------------------------

def _user_ranges(prof):
    """(name, start_ns, end_ns) of the host's annotation ranges."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda r: (r[1], -r[2]))


def _ancestors(ranges):
    """For every range (in ``ranges``' order), the names of the ranges
    enclosing it, innermost first (the ranges of one thread nest)."""
    out, stack = [], []
    for name, s, e in ranges:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append([r[0] for r in reversed(stack)])
        stack.append((name, s, e))
    return out


@pytest.fixture(scope="module")
def warm_batch_trace(_cpu_port):
    """A traced warm batched call of the robust CSTR (N = 4, B = 2,
    float64, throughput mode: one Newton step with the filter's
    acceptance test) and the host syncs the helper counted in it."""
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    from dompc_tpu_torch.systems import bench_states, cstr_robust_mpc
    mpc = cstr_robust_mpc(n_horizon=4, n_robust=1)
    solve = make_batch_solver(mpc, tol=1e-3, max_iter=60,
                              throughput_mode=True)
    x0s = bench_states(2)
    cold, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
    count0, steps0 = profiler.host_sync.count, solve.ipm.newton_steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sol, _ = solve(x0s * (1.0 + 1e-3), cold.w, cold.lam, 1e-4, cold.zl,
                       cold.zu)
    assert bool(sol.success.all())
    return dict(ranges=_user_ranges(prof),
                syncs=profiler.host_sync.count - count0,
                steps=solve.ipm.newton_steps - steps0)


def test_batched_call_spans_nest_as_the_layers(warm_batch_trace):
    ranges = warm_batch_trace["ranges"]
    names = [r[0] for r in ranges]
    assert warm_batch_trace["steps"] >= 1
    for want in ("batch.solve", "ipm.init", "ipm.evals", "ipm.step",
                 "ipm.newton", "ipm.line_search", "ipm.finish",
                 "oracle.point", "oracle.gather", "oracle.hessian",
                 "oracle.jacobian", "kkt.prepare", "kkt.solve",
                 "kkt.condense", "kkt.assemble", "kkt.bbd_solve",
                 "kkt.expand", "sync.loop", "sync.live"):
        assert want in names, want
    # every span the solve opens is in the documented list
    assert set(names) <= set(profiler.SPANS)
    ipm_ranges = {n for n in profiler.SPANS if n.startswith("ipm.")}
    for (name, _, _), up in zip(ranges, _ancestors(ranges)):
        if name == "batch.solve":
            assert up == []
        elif name.startswith("ipm."):
            assert "batch.solve" in up, name
        elif name == "oracle.point":
            assert "oracle.point" not in up
            assert ipm_ranges & set(up), up
        elif name.startswith("oracle."):
            assert up[0] == "kkt.prepare", (name, up)
        elif name in ("kkt.condense", "kkt.assemble", "kkt.bbd_solve",
                      "kkt.expand"):
            assert up[0] == "kkt.solve", (name, up)
        elif name.startswith("kkt."):
            assert "ipm.newton" in up, (name, up)
        if name.startswith("sync."):
            assert "batch.solve" in up, name
    syncs = [n for n in names if n.startswith("sync.")]
    assert len(syncs) == warm_batch_trace["syncs"] > 0


def test_span_is_one_shared_noop_without_profiler():
    a, b = profiler.span("a"), profiler.span("b")
    assert a is b
    with a:
        pass
    count = profiler.host_sync.count
    with profiler.host_sync("loop") as s:
        assert s is None
    assert profiler.host_sync.count == count + 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler.span("a") is not a
        with profiler.span("unit-span"):
            pass


def test_profile_step_reads_every_span_prefix():
    from dompc_tpu_torch.tools import profile_step
    for name in profiler.SPANS:
        assert name.startswith(profile_step.RANGES), name
    assert {"batch.", "ipm.", "kkt.", "oracle.", "sync."} <= set(
        profile_step.RANGES)
