"""Rotating oscillating masses — the reference's coupled MHE+MPC example.

Physics per reference examples/rotating_oscillating_masses_mhe_mpc/
template_model.py (three discs on torsion springs, two motor-position
inputs through a fast first-order actuator lag); MPC/MHE/simulator tuning
per the sibling templates and testing/test_rotating_oscillating_masses_
mhe_mpc.py.  A copy of the JAX package's functions, declared through the
port's API.
"""
import numpy as np

import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def rotating_masses_model():
    m = dm.model.Model("continuous")
    phi_1 = m.set_variable("_x", "phi_1")
    phi_2 = m.set_variable("_x", "phi_2")
    phi_3 = m.set_variable("_x", "phi_3")
    phi = sym.vertcat(phi_1, phi_2, phi_3)
    dphi = m.set_variable("_x", "dphi", shape=(3, 1))
    phi_m_set = m.set_variable("_u", "phi_m_set", shape=(2, 1))
    phi_m = m.set_variable("_x", "phi_m", shape=(2, 1))
    m.set_variable("_tvp", "phi_2_set")
    m.set_variable("_p", "P_p")
    m.set_variable("_tvp", "P_v", shape=(5, 5))
    m.set_meas("phi_1_meas", phi)
    m.set_meas("phi_m_set_meas", phi_m_set)
    Theta_1 = m.set_variable("_p", "Theta_1")
    Theta_2 = m.set_variable("_p", "Theta_2")
    Theta_3 = m.set_variable("_p", "Theta_3")
    c = np.array([2.697, 2.66, 3.05, 2.86]) * 1e-3
    d = np.array([6.78, 8.01, 8.82]) * 1e-5
    m.set_rhs("phi_1", dphi[0])
    m.set_rhs("phi_2", dphi[1])
    m.set_rhs("phi_3", dphi[2])
    dphi_next = sym.vertcat(
        -c[0] / Theta_1 * (phi[0] - phi_m[0])
        - c[1] / Theta_1 * (phi[0] - phi[1]) - d[0] / Theta_1 * dphi[0],
        -c[1] / Theta_2 * (phi[1] - phi[0])
        - c[2] / Theta_2 * (phi[1] - phi[2]) - d[1] / Theta_2 * dphi[1],
        -c[2] / Theta_3 * (phi[2] - phi[1])
        - c[3] / Theta_3 * (phi[2] - phi_m[1]) - d[2] / Theta_3 * dphi[2],
    )
    m.set_rhs("dphi", dphi_next)
    tau = 1e-2
    m.set_rhs("phi_m", 1 / tau * (phi_m_set - phi_m))
    m.setup()
    return m


def rotating_masses_mpc(model):
    mpc = dm.controller.MPC(model)
    mpc.settings.n_robust = 0
    mpc.settings.n_horizon = 20
    mpc.settings.t_step = 0.1
    mpc.settings.store_full_solution = True
    lterm = (model.x["phi_2"] - model.tvp["phi_2_set"]) ** 2
    mpc.set_objective(mterm=sym.const(1.0), lterm=lterm)
    mpc.set_rterm(phi_m_set=1e-2)

    # the reference test's pseudo-random setpoint trajectory (seed 999)
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
        for k in range(mpc.settings.n_horizon):
            tvp_template["_tvp", k, "phi_2_set"] = tvp_traj[ind + k]
        return tvp_template
    mpc.set_tvp_fun(tvp_fun)

    mpc.set_uncertainty_values(
        Theta_1=2.25e-4 * np.array([1.0, 1.1]),
        Theta_2=2.25e-4 * np.array([1.0]),
        Theta_3=2.25e-4 * np.array([1.0]),
    )
    mpc.bounds["lower", "_u", "phi_m_set"] = -5
    mpc.bounds["upper", "_u", "phi_m_set"] = 5
    mpc.setup()
    return mpc


def rotating_masses_simulator(model):
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.1, substeps=4)
    p_template = sim.get_p_template()

    def p_fun(t_now):
        p_template["P_p"] = 1.0
        p_template["Theta_1"] = 2.25e-4
        p_template["Theta_2"] = 2.25e-4
        p_template["Theta_3"] = 2.25e-4
        return p_template
    sim.set_p_fun(p_fun)
    tvp_template = sim.get_tvp_template()
    sim.set_tvp_fun(lambda t: tvp_template)
    sim.setup()
    return sim


def rotating_masses_mhe(model):
    mhe = dm.estimator.MHE(model, ["Theta_1"])
    mhe.settings.n_horizon = 10
    mhe.settings.t_step = 0.1
    mhe.settings.store_full_solution = True
    mhe.settings.nl_cons_check_colloc_points = True
    P_v = model.tvp["P_v"]
    P_x = 1e-4 * np.eye(8)
    P_p = model.p["P_p"]
    mhe.set_default_objective(P_x, P_v, P_p)
    tvp_template = mhe.get_tvp_template()
    for k in range(10):
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
