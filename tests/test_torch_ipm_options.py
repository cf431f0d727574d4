"""The IPM settings beyond the default path, PyTorch port against the JAX
package (float64, CPU).

* HS071 (``tests/test_ipm.py:45``) with ``globalization="merit"``,
  ``cold_dual_init``, ``dual_refit`` and ``n_refine_kkt=1`` each: the same
  iterations, and w and the multipliers within 1e-10;
* ``dynamic_bounds``: a batch of three bound sets in one call against the
  JAX solver vmapped over them, 1e-10 at equal iterations, and bound
  values refused without ``dynamic_bounds=True``;
* ``debug``: one host line per iteration and batch element;
* the oscillating masses at N=7 through the structured (``tridiag``) KKT
  solve (after ``tests/test_solver_options.py:36-69``) with ``merit`` and
  with ``n_refine_kkt=1``: ``make_step`` within 1e-10 at equal iterations,
  and each refinement pass adds one structured solve per Newton step.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dompc_tpu as jdm
import dompc_tpu_torch as tdm
from dompc_tpu.solver.ipm import (make_ipm_solver as jax_solver,
                                  IPMSettings as JaxSettings)
from dompc_tpu_torch.solver.ipm import make_ipm_solver, IPMSettings
from dompc_tpu_torch.solver import bbd
from dompc_tpu_torch.interop import mpc_state_arrays, load_mpc_state


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


TOL = 1e-10


# HS071: min x0 x3 (x0 + x1 + x2) + x2  s.t.  x0 x1 x2 x3 >= 25,
# sum x^2 = 40, 1 <= x <= 5
def _f_j(w, p):
    return w[0] * w[3] * (w[0] + w[1] + w[2]) + w[2]


def _g_j(w, p):
    return jnp.array([jnp.sum(w ** 2) - 40.0])


def _h_j(w, p):
    return jnp.array([25.0 - w[0] * w[1] * w[2] * w[3]])


def _f_t(w, p):
    return w[:, 0] * w[:, 3] * (w[:, 0] + w[:, 1] + w[:, 2]) + w[:, 2]


def _g_t(w, p):
    return (w ** 2).sum(-1, keepdim=True) - 40.0


def _h_t(w, p):
    return 25.0 - w.prod(-1, keepdim=True)


W0 = np.array([1.0, 5.0, 5.0, 1.0])
LB, UB = np.full(4, 1.0), np.full(4, 5.0)


def _assert_same(sol_t, sol_j):
    assert np.array_equal(sol_t.iterations.numpy().reshape(-1),
                          np.asarray(sol_j.iterations).reshape(-1))
    assert bool(sol_t.success.all()) and bool(np.all(sol_j.success))
    for field in ("w", "lam", "zl", "zu"):
        ref = np.asarray(getattr(sol_j, field)).reshape(
            getattr(sol_t, field).shape)
        got = getattr(sol_t, field).numpy()
        assert float(np.abs(got - ref).max()) <= TOL * max(
            1.0, float(np.abs(ref).max())), field


@pytest.mark.parametrize("setting", [
    ("globalization", "merit"), ("cold_dual_init", True),
    ("dual_refit", True), ("n_refine_kkt", 1)])
def test_hs071_setting_matches_jax(setting):
    name, value = setting
    sol_j = jax.jit(jax_solver(_f_j, _g_j, _h_j, LB, UB, 1, 1,
                               settings=JaxSettings(**{name: value})))(
        jnp.asarray(W0), jnp.zeros((0,)))
    solve = make_ipm_solver(_f_t, _g_t, _h_t, LB, UB, 1, 1,
                            settings=IPMSettings(**{name: value}))
    _assert_same(solve(torch.tensor(W0)[None], torch.zeros(1, 0)), sol_j)


def test_hs071_dynamic_bounds_match_vmapped_jax():
    lbs = np.array([[1.0, 1, 1, 1], [1.5, 1, 1, 1], [1.0, 2, 1, 1]])
    ubs = np.array([[5.0, 5, 5, 5], [5.0, 4.5, 5, 5], [5.0, 5, 3.5, 5]])
    solve_j = jax_solver(_f_j, _g_j, _h_j, LB, UB, 1, 1,
                         dynamic_bounds=True)
    sol_j = jax.jit(jax.vmap(lambda lo, hi: solve_j(
        jnp.asarray(W0), jnp.zeros((0,)), lb_dyn=lo, ub_dyn=hi)))(lbs, ubs)
    solve = make_ipm_solver(_f_t, _g_t, _h_t, LB, UB, 1, 1,
                            dynamic_bounds=True)
    sol_t = solve(torch.tensor(W0)[None].expand(3, 4), torch.zeros(3, 0),
                  lb_dyn=lbs, ub_dyn=ubs)
    _assert_same(sol_t, sol_j)
    # one Newton step a loop pass but the last, which certifies
    assert solve.newton_steps == int(sol_t.iterations.max()) - 1
    # the tightened bounds hold
    w = sol_t.w.numpy()
    assert np.all(w >= lbs - 1e-8) and np.all(w <= ubs + 1e-8)
    static = make_ipm_solver(_f_t, _g_t, _h_t, LB, UB, 1, 1)
    with pytest.raises(ValueError):
        static(torch.tensor(W0)[None], torch.zeros(1, 0), lb_dyn=lbs[:1])


def test_debug_prints_each_iteration(capsys):
    solve = make_ipm_solver(_f_t, _g_t, _h_t, LB, UB, 1, 1,
                            settings=IPMSettings(debug=True, max_iter=3))
    sol = solve(torch.tensor(W0)[None].expand(2, 4), torch.zeros(2, 0))
    lines = capsys.readouterr().out.splitlines()
    its = [ln for ln in lines if " it=" in ln]
    assert len(its) == 2 * int(sol.iterations.max()) == 6
    assert any("polish:" in ln for ln in lines)


def _osc_mpc(dm, name, value):
    """tests/test_solver_options.py:36-69's MPC, structured, with one
    setting changed."""
    model = (jdm.systems if dm is jdm else tdm.systems) \
        .oscillating_masses_model()
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = 7
    s.t_step = 0.5
    s.solver_mu_init = 1e-2
    s.solver_use_soc = False
    s.solver_do_polish = False
    s.solver_reg_retries = 2
    s.nlpsol_opts = {"ipopt.tol": 1e-9}
    s.kkt_solver = "tridiag"
    setattr(s, name, value)
    mpc.set_objective(mterm=model.aux["cost"], lterm=model.aux["cost"])
    mpc.set_rterm(u=1e-4)
    mpc.bounds["lower", "_u", "u"] = -0.5
    mpc.bounds["upper", "_u", "u"] = 0.5
    mpc.setup()
    return mpc


@pytest.mark.parametrize("setting", [("solver_globalization", "merit"),
                                     ("solver_n_refine_kkt", 1)])
def test_oscillating_masses_structured_setting_matches_jax(setting,
                                                          monkeypatch):
    import dompc_tpu.systems  # noqa: F401
    name, value = setting
    np.random.seed(99)
    x0 = np.random.rand(4) - 0.5
    mj, mt = _osc_mpc(jdm, name, value), _osc_mpc(tdm, name, value)
    mj.x0 = x0
    mj.set_initial_guess()
    load_mpc_state(mt, mpc_state_arrays(mj))
    solves = []
    real = bbd.bbd_solve

    def counted(*a, **kw):
        solves.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(bbd, "bbd_solve", counted)
    u_j = mj.make_step(x0)
    u_t = mt.make_step(x0)
    assert mt.solver_stats["success"] and mj.solver_stats["success"]
    assert mt.solver_stats["iter_count"] == mj.solver_stats["iter_count"]
    assert float(np.abs(u_t - u_j).max()) <= TOL
    assert float(np.abs(mt.opt_x_num - np.asarray(mj.opt_x_num)).max()) \
        <= TOL
    if name == "solver_n_refine_kkt":
        # one solve a Newton step and one a refinement pass (no rung of
        # the ladder or correction runs on this problem)
        assert len(solves) == 2 * mt._solve_raw.newton_steps
