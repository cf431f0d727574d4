"""Industrial batch polymerization reactor — the reference's flagship
large example (10 states, 3 inputs, robust multi-stage over 2 uncertain
parameters → 9-branch scenario tree).

Physics per reference examples/industrial_poly/template_model.py
(exothermic polymerization with jacket + external heat exchanger cooling,
adiabatic safety temperature as a state); MPC/simulator tuning per the
sibling templates.  A copy of the JAX package's functions, declared
through the port's API.
"""
import numpy as np

import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def industrial_poly_model():
    m = dm.model.Model("continuous")

    # certain parameters
    R = 8.314                # gas constant
    T_F = 25 + 273.15        # feed temperature
    E_a = 8500.0             # activation energy
    A_tank = 65.0            # jacket heat-exchange area
    k_U2 = 32.0              # reaction parameter 1
    k_U1 = 4.0               # reaction parameter 2
    w_WF = .333              # mass fraction water in feed
    w_AF = .667              # mass fraction monomer in feed
    m_M_KW = 5000.0          # coolant mass, jacket
    fm_M_KW = 300000.0       # coolant flow, jacket
    m_AWT_KW = 1000.0        # coolant mass, external heat exchanger (EHE)
    fm_AWT_KW = 100000.0     # coolant flow, EHE
    m_AWT = 200.0            # product mass in EHE
    fm_AWT = 20000.0         # product flow through EHE
    m_S = 39000.0            # reactor steel mass
    c_pW, c_pS, c_pF, c_pR = 4.2, .47, 3.0, 5.0   # specific heats
    k_WS, k_AS, k_PS = 17280.0, 3600.0, 360.0     # heat-transfer coeffs
    alfa = 5 * 20e4 * 3.6
    p_1 = 1.0

    m_W = m.set_variable("_x", "m_W")
    m_A = m.set_variable("_x", "m_A")
    m_P = m.set_variable("_x", "m_P")
    T_R = m.set_variable("_x", "T_R")
    T_S = m.set_variable("_x", "T_S")
    Tout_M = m.set_variable("_x", "Tout_M")
    T_EK = m.set_variable("_x", "T_EK")
    Tout_AWT = m.set_variable("_x", "Tout_AWT")
    m.set_variable("_x", "accum_monom")
    m.set_variable("_x", "T_adiab")

    m_dot_f = m.set_variable("_u", "m_dot_f")
    T_in_M = m.set_variable("_u", "T_in_M")
    T_in_EK = m.set_variable("_u", "T_in_EK")

    # uncertain parameters: reaction enthalpy and rate constant
    delH_R = m.set_variable("_p", "delH_R")
    k_0 = m.set_variable("_p", "k_0")

    U_m = m_P / (m_A + m_P)
    m_ges = m_W + m_A + m_P
    k_R1 = k_0 * sym.exp(-E_a / (R * T_R)) * (k_U1 * (1 - U_m) + k_U2 * U_m)
    k_R2 = k_0 * sym.exp(-E_a / (R * T_EK)) * (k_U1 * (1 - U_m) + k_U2 * U_m)
    k_K = (m_W * k_WS + m_A * k_AS + m_P * k_PS) / m_ges

    m_A_R = m_A - m_A * m_AWT / m_ges   # monomer mass in the reactor proper
    dot_m_W = m_dot_f * w_WF
    dot_m_A = (m_dot_f * w_AF - k_R1 * m_A_R
               - p_1 * k_R2 * (m_A / m_ges) * m_AWT)
    dot_m_P = k_R1 * m_A_R + p_1 * k_R2 * (m_A / m_ges) * m_AWT
    dot_T_R = 1. / (c_pR * m_ges) * (
        m_dot_f * c_pF * (T_F - T_R) - k_K * A_tank * (T_R - T_S)
        - fm_AWT * c_pR * (T_R - T_EK) + delH_R * k_R1 * m_A_R)

    m.set_rhs("m_W", dot_m_W)
    m.set_rhs("m_A", dot_m_A)
    m.set_rhs("m_P", dot_m_P)
    m.set_rhs("T_R", dot_T_R)
    m.set_rhs("T_S", 1. / (c_pS * m_S) * (k_K * A_tank * (T_R - T_S)
                                          - k_K * A_tank * (T_S - Tout_M)))
    m.set_rhs("Tout_M", 1. / (c_pW * m_M_KW) * (
        fm_M_KW * c_pW * (T_in_M - Tout_M) + k_K * A_tank * (T_S - Tout_M)))
    m.set_rhs("T_EK", 1. / (c_pR * m_AWT) * (
        fm_AWT * c_pR * (T_R - T_EK) - alfa * (T_EK - Tout_AWT)
        + p_1 * k_R2 * (m_A / m_ges) * m_AWT * delH_R))
    m.set_rhs("Tout_AWT", 1. / (c_pW * m_AWT_KW) * (
        fm_AWT_KW * c_pW * (T_in_EK - Tout_AWT) - alfa * (Tout_AWT - T_EK)))
    m.set_rhs("accum_monom", m_dot_f)
    m.set_rhs("T_adiab",
              delH_R / (m_ges * c_pR) * dot_m_A
              - (dot_m_A + dot_m_W + dot_m_P)
              * (m_A * delH_R / (m_ges * m_ges * c_pR)) + dot_T_R)
    m.setup()
    return m


def industrial_poly_mpc(model, n_horizon=20, n_robust=1):
    """Robust multi-stage product-maximizing MPC
    (reference: examples/industrial_poly/template_mpc.py)."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.n_robust = n_robust
    s.t_step = 50.0 / 3600.0
    s.store_full_solution = True

    mpc.set_objective(mterm=-model.x["m_P"], lterm=-model.x["m_P"])
    mpc.set_rterm(m_dot_f=0.002, T_in_M=0.004, T_in_EK=0.002)

    temp_range = 2.0
    mpc.bounds["lower", "_x", "m_W"] = 0.0
    mpc.bounds["lower", "_x", "m_A"] = 0.0
    mpc.bounds["lower", "_x", "m_P"] = 26.0
    mpc.bounds["lower", "_x", "T_R"] = 363.15 - temp_range
    mpc.bounds["lower", "_x", "T_S"] = 298.0
    mpc.bounds["lower", "_x", "Tout_M"] = 298.0
    mpc.bounds["lower", "_x", "T_EK"] = 288.0
    mpc.bounds["lower", "_x", "Tout_AWT"] = 288.0
    mpc.bounds["lower", "_x", "accum_monom"] = 0.0
    mpc.bounds["upper", "_x", "T_S"] = 400.0
    mpc.bounds["upper", "_x", "Tout_M"] = 400.0
    mpc.bounds["upper", "_x", "T_EK"] = 400.0
    mpc.bounds["upper", "_x", "Tout_AWT"] = 400.0
    mpc.bounds["upper", "_x", "accum_monom"] = 30000.0
    mpc.bounds["upper", "_x", "T_adiab"] = 382.15
    mpc.bounds["lower", "_u", "m_dot_f"] = 0.0
    mpc.bounds["lower", "_u", "T_in_M"] = 333.15
    mpc.bounds["lower", "_u", "T_in_EK"] = 333.15
    mpc.bounds["upper", "_u", "m_dot_f"] = 3.0e4
    mpc.bounds["upper", "_u", "T_in_M"] = 373.15
    mpc.bounds["upper", "_u", "T_in_EK"] = 373.15

    mpc.scaling["_x", "m_W"] = 10
    mpc.scaling["_x", "m_A"] = 10
    mpc.scaling["_x", "m_P"] = 10
    mpc.scaling["_x", "accum_monom"] = 10
    mpc.scaling["_u", "m_dot_f"] = 100

    if n_robust == 0:
        mpc.set_nl_cons("T_R_UB", model.x["T_R"], ub=363.15 + temp_range,
                        soft_constraint=True, penalty_term_cons=1e4)
    else:
        mpc.bounds["upper", "_x", "T_R"] = 363.15 + temp_range

    mpc.set_uncertainty_values(
        delH_R=np.array([950.0, 950.0 * 1.30, 950.0 * 0.70]),
        k_0=np.array([7.0, 7.0 * 1.30, 7.0 * 0.70]))
    mpc.setup()
    return mpc


def industrial_poly_simulator(model):
    sim = dm.Simulator(model)
    sim.set_param(t_step=50.0 / 3600.0, substeps=4)
    p_num = sim.get_p_template()
    p_num["delH_R"] = 950
    p_num["k_0"] = 7
    sim.set_p_fun(lambda t: p_num)
    sim.setup()
    return sim


def industrial_poly_x0(delH_R_real=950.0 * 1.00, c_pR=5.0):
    """Reference examples/industrial_poly/main.py:64-73 initial state;
    T_adiab is consistent with (m_W, m_A, m_P, T_R)."""
    m_W, m_A, m_P, T_R = 10000.0, 853.0, 26.5, 90.0 + 273.15
    T_adiab = m_A * delH_R_real / ((m_W + m_A + m_P) * c_pR) + T_R
    return np.array([m_W, m_A, m_P, T_R, 90.0 + 273.15, 90.0 + 273.15,
                     35.0 + 273.15, 35.0 + 273.15, 300.0, T_adiab])
