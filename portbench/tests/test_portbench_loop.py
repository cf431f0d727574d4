"""Tiny CPU rehearsals of the cells' loops through the harness, and the
faults the comparison must catch: each run skips the look for a card
(``cpu=True``) and drives the rest of a run at a small horizon and
batch."""
import numpy as np
import pytest
import torch

from portbench.harness import bench, registry
from portbench.harness.control import rounded_answers, tf32_round

BENCH = registry.load_benchmark()
SMALL = dict(cpu=True, n_horizon=4, batch=4)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("DOMPC_TPU_X64", raising=False)


def _run(cell_name, trace=False, hook=None, seconds=0.3, **kw):
    cell = registry.Cell(BENCH, cell_name)
    opts = dict(SMALL, **kw)
    return bench.run_cell(cell, 2 ** 31 + 5, seconds, trace,
                          program_hook=hook, log=lambda rec: None, **opts)


@pytest.mark.parametrize("cell,trace", [("cstr_fleet_warm", False),
                                        ("cstr_fleet_warm", True),
                                        ("cstr_sample_cold", True)])
def test_cell_rehearsal(cell, trace):
    result, compared = _run(cell, trace=trace)
    assert result["correct"], compared
    assert list(result)[-1] == "compared"
    assert result["attempted"] >= 4 and result["failed"] == 0
    names = {m["name"] for m in (registry.Cell(BENCH, cell).per_layer
                                 if trace else
                                 registry.Cell(BENCH, cell).end_to_end)}
    got = set(result["metrics"])
    if trace:
        # the CPU run has no device events: only the host readers read
        assert {"newton_steps_per_call", "prepare_ms_per_step",
                "kkt_solve_ms_per_step", "ipm_self_ms_per_step"} <= got
        assert "band_roofline" not in got
        assert "breakdown" in result
    else:
        assert got == names
    assert bench.forbidden_modules() == []


def _solution_like(sol, **fields):
    return sol._replace(**fields)


def _u0_of(prog, w):
    mpc = prog.mpc
    sl = mpc.layout.sl(("u", 0, 0))
    return w[:, sl] * torch.as_tensor(mpc._u_scaling.data, dtype=w.dtype)


SETUP_CALLS = {"cstr_fleet_warm": 2, "cstr_sample_cold": 1}


def fault_unchanged(prog, setup_calls):
    """The solve hands its starting point back as the answer, from the
    window's first call on (the set-up's calls solve): in the warm cell
    each period then returns the last period's answer, in the cold cell
    the initial guess."""
    solve = prog.solve
    calls = []

    def wrapped(x0s, w0s, lam0s=None, mu0=None, zl0s=None, zu0s=None):
        sol, u0 = solve(x0s, w0s, lam0s, mu0, zl0s, zu0s)
        calls.append(1)
        if len(calls) <= setup_calls:
            return sol, u0
        w0 = torch.as_tensor(w0s, dtype=sol.w.dtype)
        fields = dict(w=w0)
        if lam0s is not None:
            fields.update(lam=lam0s, zl=zl0s, zu=zu0s)
        return _solution_like(sol, **fields), _u0_of(prog, w0)
    wrapped.ipm = solve.ipm
    prog.solve = wrapped


def fault_half_batch(prog):
    """Half of the batch is solved; the rest gets the solved half's
    answers."""
    solve = prog.solve

    def wrapped(x0s, w0s, *warm):
        h = x0s.shape[0] // 2
        part = [a if a is None or np.ndim(a) == 0 else a[:h] for a in warm]
        sol, u0 = solve(x0s[:h], w0s[:h], *part)
        rep = torch.arange(x0s.shape[0]) % h
        sol = sol.__class__(*(t[rep] for t in sol))
        return sol, u0[rep]
    wrapped.ipm = solve.ipm
    prog.solve = wrapped


def fault_answer_altered(prog):
    """One instance's u0 is altered where it is produced."""
    solve = prog.solve

    def wrapped(*args):
        sol, u0 = solve(*args)
        u0 = u0.clone()
        u0[0] = u0[0] * 1.01
        return sol, u0
    wrapped.ipm = solve.ipm
    prog.solve = wrapped


def fault_dual_sign(prog):
    """One instance's largest bound dual comes back with its sign flipped:
    complementarity read by its absolute value does not see it."""
    solve = prog.solve

    def wrapped(*args):
        sol, u0 = solve(*args)
        zl = sol.zl.clone()
        j = int(zl[0].argmax())
        zl[0, j] = -zl[0, j]
        return _solution_like(sol, zl=zl), u0
    wrapped.ipm = solve.ipm
    prog.solve = wrapped


@pytest.mark.parametrize("cell", ["cstr_fleet_warm", "cstr_sample_cold"])
@pytest.mark.parametrize("fault", [fault_unchanged, fault_half_batch,
                                   fault_answer_altered, fault_dual_sign,
                                   rounded_answers])
def test_faults_come_out_not_correct(cell, fault):
    """Each fault, and the control (answers rounded to TF32), fails the
    comparison; 16 instances, so that a stale answer's state move exceeds
    the tolerance somewhere."""
    hook = fault
    if fault is fault_unchanged:
        def hook(prog):
            fault_unchanged(prog, SETUP_CALLS[cell])
    result, compared = _run(cell, hook=hook, batch=16)
    assert result["correct"] is False, compared


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.14159265,
                      0.0])
    y = tf32_round(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2.0 ** -10
    assert y[1] == 1.0 + 2.0 ** -10          # a tie rounds up
    assert abs(float(y[3]) + 3.14159265) < 2.0 ** -10 * 4
    assert y[4] == 0.0
    mant = y.view(torch.int32) & 0x1FFF
    assert bool((mant == 0).all())


@pytest.mark.parametrize("tol", [1.2e-3, 1.6e-3])
def test_looser_stopping_test_comes_out_not_correct(tol):
    """A solver that stops at a looser tolerance than the configuration's
    1e-3 certifies points the reference reads above ``kkt_err_max``.  The
    cold cell shows it; a warm period's one Newton step lands below 1e-3
    whatever the tolerance, so there the answers are the same."""
    def hook(prog):
        prog.solve = prog.solver(tol=tol)
    result, compared = _run("cstr_sample_cold", hook=hook, batch=16)
    assert result["correct"] is False, compared
    assert result["failed"] == 0
    numbers = {name: value for name, value, _ in compared}
    assert 1.1e-3 < numbers["kkt_err_max"] <= tol * 1.001
