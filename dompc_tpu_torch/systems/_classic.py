"""Systems of the reference examples (copies of the JAX package's
``systems/_classic.py`` functions, declared through the port's API)."""
import numpy as np

import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def oscillating_masses_model():
    """Reference: examples/oscillating_masses_discrete/template_model.py."""
    m = dm.model.Model("discrete")
    x = m.set_variable("_x", "x", (4, 1))
    u = m.set_variable("_u", "u", (1, 1))
    m.set_expression("cost", sym.sum1(x**2))
    A = np.array([[0.763, 0.460, 0.115, 0.020],
                  [-0.899, 0.763, 0.420, 0.115],
                  [0.115, 0.020, 0.763, 0.460],
                  [0.420, 0.115, -0.899, 0.763]])
    B = np.array([[0.014], [0.063], [0.221], [0.367]])
    m.set_rhs("x", A @ x + B @ u)
    m.setup()
    return m


def oscillating_masses_mpc(model):
    """Reference: examples/oscillating_masses_discrete/template_mpc.py."""
    mpc = dm.controller.MPC(model)
    mpc.settings.n_robust = 0
    mpc.settings.n_horizon = 7
    mpc.settings.t_step = 0.5
    mpc.settings.store_full_solution = True
    mpc.set_objective(mterm=model.aux["cost"], lterm=model.aux["cost"])
    mpc.set_rterm(u=1e-4)
    max_x = np.array([[4.0], [10.0], [4.0], [10.0]])
    mpc.bounds["lower", "_x", "x"] = -max_x
    mpc.bounds["upper", "_x", "x"] = max_x
    mpc.bounds["lower", "_u", "u"] = -0.5
    mpc.bounds["upper", "_u", "u"] = 0.5
    mpc.setup()
    return mpc


def cstr_model():
    """Reference: examples/CSTR/template_model.py."""
    m = dm.model.Model("continuous")
    K0_ab, K0_bc, K0_ad = 1.287e12, 1.287e12, 9.043e9
    E_A_ab, E_A_bc, E_A_ad = 9758.3, 9758.3, 8560.0
    H_R_ab, H_R_bc, H_R_ad = 4.2, -11.0, -41.85
    Rou, Cp, Cp_k = 0.9342, 3.01, 2.0
    A_R, V_R, m_k = 0.215, 10.01, 5.0
    T_in, K_w = 130.0, 4032.0
    C_A0 = (5.7 + 4.5) / 2.0

    C_a = m.set_variable("_x", "C_a")
    C_b = m.set_variable("_x", "C_b")
    T_R = m.set_variable("_x", "T_R")
    T_K = m.set_variable("_x", "T_K")
    F = m.set_variable("_u", "F")
    Q_dot = m.set_variable("_u", "Q_dot")
    alpha = m.set_variable("_p", "alpha")
    beta = m.set_variable("_p", "beta")
    T_dif = m.set_expression("T_dif", T_R - T_K)
    K_1 = beta * K0_ab * sym.exp((-E_A_ab) / (T_R + 273.15))
    K_2 = K0_bc * sym.exp((-E_A_bc) / (T_R + 273.15))
    K_3 = K0_ad * sym.exp((-alpha * E_A_ad) / (T_R + 273.15))
    m.set_rhs("C_a", F * (C_A0 - C_a) - K_1 * C_a - K_3 * (C_a**2))
    m.set_rhs("C_b", -F * C_b + K_1 * C_a - K_2 * C_b)
    m.set_rhs("T_R", ((K_1 * C_a * H_R_ab + K_2 * C_b * H_R_bc
                       + K_3 * (C_a**2) * H_R_ad) / (-Rou * Cp))
              + F * (T_in - T_R) + (((K_w * A_R) * (-T_dif))
                                    / (Rou * Cp * V_R)))
    m.set_rhs("T_K", (Q_dot + K_w * A_R * T_dif) / (m_k * Cp_k))
    m.setup()
    return m


def cstr_mpc(model):
    """Reference: examples/CSTR/template_mpc.py."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = 20
    s.n_robust = 1
    s.open_loop = 0
    s.t_step = 0.005
    s.state_discretization = "collocation"
    s.collocation_type = "radau"
    s.collocation_deg = 2
    s.collocation_ni = 1
    s.store_full_solution = True
    mpc.scaling["_x", "T_R"] = 100
    mpc.scaling["_x", "T_K"] = 100
    mpc.scaling["_u", "Q_dot"] = 2000
    mpc.scaling["_u", "F"] = 100
    mterm = (model.x["C_b"] - 0.6) ** 2
    lterm = (model.x["C_b"] - 0.6) ** 2
    mpc.set_objective(mterm=mterm, lterm=lterm)
    mpc.set_rterm(F=0.1, Q_dot=1e-3)
    mpc.bounds["lower", "_x", "C_a"] = 0.1
    mpc.bounds["lower", "_x", "C_b"] = 0.1
    mpc.bounds["lower", "_x", "T_R"] = 50
    mpc.bounds["lower", "_x", "T_K"] = 50
    mpc.bounds["upper", "_x", "C_a"] = 2
    mpc.bounds["upper", "_x", "C_b"] = 2
    mpc.bounds["upper", "_x", "T_K"] = 140
    mpc.bounds["lower", "_u", "F"] = 5
    mpc.bounds["lower", "_u", "Q_dot"] = -8500
    mpc.bounds["upper", "_u", "F"] = 100
    mpc.bounds["upper", "_u", "Q_dot"] = 0.0
    mpc.set_nl_cons("T_R", model.x["T_R"], ub=140, soft_constraint=True,
                    penalty_term_cons=1e2)
    mpc.set_uncertainty_values(alpha=np.array([1., 1.05, 0.95]),
                               beta=np.array([1., 1.1, 0.9]))
    mpc.setup()
    return mpc


def cstr_simulator(model):
    sim = dm.Simulator(model)
    sim.set_param(integration_tool="cvodes", abstol=1e-10, reltol=1e-10,
                  t_step=0.005, substeps=6)
    tvp_num = sim.get_tvp_template()
    sim.set_tvp_fun(lambda t: tvp_num)
    p_num = sim.get_p_template()
    p_num["alpha"] = 1
    p_num["beta"] = 1
    sim.set_p_fun(lambda t: p_num)
    sim.setup()
    return sim


def batch_reactor_model():
    """Reference: examples/batch_reactor/template_model.py."""
    m = dm.model.Model("continuous")
    mu_m, K_m, K_i, v_par, Y_p = 0.02, 0.05, 5.0, 0.004, 1.2
    X_s = m.set_variable("_x", "X_s")
    S_s = m.set_variable("_x", "S_s")
    P_s = m.set_variable("_x", "P_s")
    V_s = m.set_variable("_x", "V_s")
    inp = m.set_variable("_u", "inp")
    Y_x = m.set_variable("_p", "Y_x")
    S_in = m.set_variable("_p", "S_in")
    mu_S = mu_m * S_s / (K_m + S_s + (S_s**2 / K_i))
    m.set_rhs("X_s", mu_S * X_s - inp / V_s * X_s)
    m.set_rhs("S_s", -mu_S * X_s / Y_x - v_par * X_s / Y_p
              + inp / V_s * (S_in - S_s))
    m.set_rhs("P_s", v_par * X_s - inp / V_s * P_s)
    m.set_rhs("V_s", inp)
    m.setup()
    return m


def batch_reactor_mpc(model):
    """Reference: examples/batch_reactor/template_mpc.py."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = 20
    s.n_robust = 0
    s.t_step = 1.0
    s.collocation_deg = 2
    s.collocation_ni = 2
    s.store_full_solution = True
    mpc.set_objective(mterm=-model.x["P_s"], lterm=-model.x["P_s"])
    mpc.set_rterm(inp=1.0)
    mpc.bounds["lower", "_x", "X_s"] = 0.0
    mpc.bounds["lower", "_x", "S_s"] = -0.01
    mpc.bounds["lower", "_x", "P_s"] = 0.0
    mpc.bounds["lower", "_x", "V_s"] = 0.0
    mpc.bounds["upper", "_x", "X_s"] = 3.7
    mpc.bounds["upper", "_x", "P_s"] = 3.0
    mpc.bounds["lower", "_u", "inp"] = 0.0
    mpc.bounds["upper", "_u", "inp"] = 0.2
    mpc.set_uncertainty_values(Y_x=np.array([0.5, 0.4, 0.3]),
                               S_in=np.array([200.0, 220.0, 180.0]))
    mpc.setup()
    return mpc


def lotka_volterra_model():
    """Reference: examples/Lotka_Volterra/template_model.py."""
    m = dm.model.Model("continuous")
    c0, c1 = 0.4, 0.2
    x_0 = m.set_variable("_x", "x_0")
    x_1 = m.set_variable("_x", "x_1")
    inp = m.set_variable("_u", "inp")
    m.set_rhs("x_0", x_0 - x_0 * x_1 - c0 * x_0 * inp)
    m.set_rhs("x_1", -x_1 + x_0 * x_1 - c1 * x_1 * inp)
    m.setup()
    return m
