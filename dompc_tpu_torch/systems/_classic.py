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
