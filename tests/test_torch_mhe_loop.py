"""The coupled MHE + MPC loop of the rotating masses, the PyTorch port
against the JAX package (float64, CPU): ``mpc.make_step`` ->
``Simulator.make_step`` -> ``mhe.make_step``, as
``tests/test_mhe_rotating_masses.py:14-44`` runs it (seed 99).

* 2 steps at reduced horizons (MPC N=5, MHE N=4; built here with the
  systems' settings and the shorter horizons): the inputs, the plant, the
  estimates and the estimated parameter within 1e-8 of JAX, the MPC at
  equal iterations.  The MHE's iterations are not compared: on its warm
  step the JAX package's compiled solver evaluates the measurement rows
  of g differently from the same g compiled alone (XLA:CPU at its default
  optimization level; at ``--xla_backend_optimization_level=0`` JAX takes
  the port's iteration count), and the two reach the same estimate by
  different paths;
* (slow) the full-width loop of that test (MPC N=20, MHE N=10), 5 steps,
  with the same bounds.
"""
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems as jsys
import dompc_tpu_torch as tdm
import dompc_tpu_torch.systems as tsys


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def short_mpc(dm, model, n_horizon):
    """``systems.rotating_masses_mpc`` (its settings, setpoint trajectory
    and uncertainty values) at a shorter horizon."""
    sym = dm.sym
    mpc = dm.controller.MPC(model)
    mpc.settings.n_robust = 0
    mpc.settings.n_horizon = n_horizon
    mpc.settings.t_step = 0.1
    mpc.settings.store_full_solution = True
    mpc.set_objective(mterm=sym.const(1.0),
                      lterm=(model.x["phi_2"] - model.tvp["phi_2_set"]) ** 2)
    mpc.set_rterm(phi_m_set=1e-2)
    np.random.seed(999)
    tvp_traj = [np.array([0.0])]
    for i in range(400):
        tvp_next = (0.5 - np.random.rand()) * np.pi
        switch = np.random.rand() >= 0.95
        tvp_traj.append((1 - switch) * tvp_traj[i] + switch * tvp_next)
    tvp_traj = np.concatenate(tvp_traj)
    tvp_template = mpc.get_tvp_template()

    def tvp_fun(t_now):
        ind = int(t_now / mpc.settings.t_step)
        for k in range(n_horizon):
            tvp_template["_tvp", k, "phi_2_set"] = tvp_traj[ind + k]
        return tvp_template
    mpc.set_tvp_fun(tvp_fun)
    mpc.set_uncertainty_values(Theta_1=2.25e-4 * np.array([1.0, 1.1]),
                               Theta_2=2.25e-4 * np.array([1.0]),
                               Theta_3=2.25e-4 * np.array([1.0]))
    mpc.bounds["lower", "_u", "phi_m_set"] = -5
    mpc.bounds["upper", "_u", "phi_m_set"] = 5
    mpc.setup()
    return mpc


def short_mhe(dm, model, n_horizon):
    """``systems.rotating_masses_mhe`` (weights, parameters, bounds and the
    nl_cons bounds on Theta_1) at a shorter horizon."""
    mhe = dm.estimator.MHE(model, ["Theta_1"])
    mhe.settings.n_horizon = n_horizon
    mhe.settings.t_step = 0.1
    mhe.settings.store_full_solution = True
    mhe.settings.nl_cons_check_colloc_points = True
    mhe.set_default_objective(1e-4 * np.eye(8), model.tvp["P_v"],
                              model.p["P_p"])
    tvp_template = mhe.get_tvp_template()
    for k in range(n_horizon):
        tvp_template["_tvp", k, "P_v"] = np.diag(
            np.array([1.0, 1, 1, 20, 20]))
    mhe.set_tvp_fun(lambda t: tvp_template)
    p_template = mhe.get_p_template()

    def p_fun_mhe(t_now):
        p_template["P_p"] = 1.0
        p_template["Theta_2"] = 2.25e-4
        p_template["Theta_3"] = 2.25e-4
        return p_template
    mhe.set_p_fun(p_fun_mhe)
    y_template = mhe.get_y_template()

    def y_fun(t_now):
        n_steps = min(mhe.data._y.shape[0], mhe.settings.n_horizon)
        for k in range(-n_steps, 0):
            y_template["y_meas", k] = mhe.data._y[k]
        return y_template
    mhe.set_y_fun(y_fun)
    mhe.bounds["lower", "_u", "phi_m_set"] = -5
    mhe.bounds["upper", "_u", "phi_m_set"] = 5
    mhe.bounds["lower", "_x", "dphi"] = -6
    mhe.bounds["upper", "_x", "dphi"] = 6
    mhe.set_nl_cons("p_est_lb", -mhe._p_est["Theta_1"] + 1e-5, 0)
    mhe.set_nl_cons("p_est_ub", mhe._p_est["Theta_1"] - 1e-3, 0)
    mhe.setup()
    return mhe


def coupled_loop(mpc, sim, mhe, n_steps):
    """tests/test_mhe_rotating_masses.py:20-35: seed 99, x0 = 0 for the
    controller and the estimator, a random true state for the plant.
    Returns the inputs, plant outputs, estimates, estimated parameter,
    both solvers' iterations and whether both certified, per step."""
    model = mpc.model
    np.random.seed(99)
    x0_true = np.random.rand(model.n_x) - 0.5
    x0 = np.zeros(model.n_x)
    mpc.x0 = x0
    sim.x0 = x0_true
    mhe.x0 = x0
    mhe.p_est0 = 1e-4
    mpc.set_initial_guess()
    mhe.set_initial_guess()
    rec = {k: [] for k in ("u", "y", "x", "p_est", "mpc_iters",
                           "mhe_iters", "certified")}
    for _ in range(n_steps):
        u0 = mpc.make_step(x0)
        y_next = sim.make_step(u0)
        x0 = mhe.make_step(y_next)
        rec["certified"].append(mpc.solver_stats["success"]
                                and mhe.solver_stats["success"])
        for key, val in (("u", u0), ("y", y_next), ("x", x0),
                         ("p_est", mhe._p_est0.data)):
            rec[key].append(np.array(val, dtype=float).ravel())
        rec["mpc_iters"].append(mpc.solver_stats["iter_count"])
        rec["mhe_iters"].append(mhe.solver_stats["iter_count"])
    return rec


def _assert_loops_agree(rec_t, rec_j, bound,
                        keys=("u", "y", "x", "p_est")):
    assert all(rec_t["certified"]) and all(rec_j["certified"])
    assert rec_t["mpc_iters"] == rec_j["mpc_iters"]
    for key in keys:
        err = _rel(rec_t[key], rec_j[key])
        assert err <= bound, f"{key}: rel {err:.2e} (bound {bound:g})"


@pytest.fixture(scope="module")
def reduced_loops(_cpu_port):
    """Both packages' coupled loop at reduced horizons, 2 steps."""
    out = {}
    for dm, systems in ((jdm, jsys), (tdm, tsys)):
        model = systems.rotating_masses_model()
        out[dm.__name__] = coupled_loop(
            short_mpc(dm, model, 5), systems.rotating_masses_simulator(model),
            short_mhe(dm, model, 4), n_steps=2)
    return out["dompc_tpu_torch"], out["dompc_tpu"]


@pytest.mark.parametrize("key", ["u", "y", "x", "p_est"])
def test_coupled_loop_reduced_horizons(reduced_loops, key):
    """Each quantity of the loop (inputs, plant outputs, estimates, the
    estimated parameter) within 1e-8 of JAX, the MPC at equal
    iterations."""
    _assert_loops_agree(*reduced_loops, 1e-8, keys=(key,))


def test_coupled_loop_reduced_horizons_certifies(reduced_loops):
    """Every MPC and MHE step of both packages' loops certifies."""
    for rec in reduced_loops:
        assert rec["certified"] == [True, True]


@pytest.mark.slow
def test_coupled_loop_full_width():
    out = {}
    for systems in (jsys, tsys):
        model = systems.rotating_masses_model()
        out[systems.__name__] = coupled_loop(
            systems.rotating_masses_mpc(model),
            systems.rotating_masses_simulator(model),
            systems.rotating_masses_mhe(model), n_steps=5)
    _assert_loops_agree(out["dompc_tpu_torch.systems"],
                        out["dompc_tpu.systems"], 1e-8)
