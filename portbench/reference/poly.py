"""do-mpc's industrial polymerization reactor
(examples/industrial_poly/template_model.py, template_mpc.py): an
exothermic semi-batch polymerization with jacket and external heat
exchanger cooling, states (m_W, m_A, m_P, T_R, T_S, Tout_M, T_EK,
Tout_AWT, accum_monom, T_adiab), inputs (m_dot_f, T_in_M, T_in_EK),
uncertain parameters (delH_R, k_0), the reaction enthalpy and the rate
constant.

Plain PyTorch on unscaled tensors whose last axis holds the variables in
that order; any leading axes broadcast."""
import numpy as np
import torch

R = 8.314
T_F = 25 + 273.15
E_a = 8500.0
A_tank = 65.0
k_U2, k_U1 = 32.0, 4.0
w_WF, w_AF = .333, .667
m_M_KW, fm_M_KW = 5000.0, 300000.0
m_AWT_KW, fm_AWT_KW = 1000.0, 100000.0
m_AWT, fm_AWT = 200.0, 20000.0
m_S = 39000.0
c_pW, c_pS, c_pF, c_pR = 4.2, .47, 3.0, 5.0
k_WS, k_AS, k_PS = 17280.0, 3600.0, 360.0
alfa = 5 * 20e4 * 3.6
p_1 = 1.0


def rhs(x, u, p):
    (m_W, m_A, m_P, T_R, T_S, Tout_M, T_EK, Tout_AWT, _accum,
     _T_adiab) = x.unbind(-1)
    m_dot_f, T_in_M, T_in_EK = u.unbind(-1)
    delH_R, k_0 = p.unbind(-1)
    U_m = m_P / (m_A + m_P)
    m_ges = m_W + m_A + m_P
    k_R1 = k_0 * torch.exp(-E_a / (R * T_R)) * (k_U1 * (1 - U_m) + k_U2 * U_m)
    k_R2 = k_0 * torch.exp(-E_a / (R * T_EK)) * (k_U1 * (1 - U_m)
                                                 + k_U2 * U_m)
    k_K = (m_W * k_WS + m_A * k_AS + m_P * k_PS) / m_ges
    m_A_R = m_A - m_A * m_AWT / m_ges
    dot_m_W = m_dot_f * w_WF
    dot_m_A = (m_dot_f * w_AF - k_R1 * m_A_R
               - p_1 * k_R2 * (m_A / m_ges) * m_AWT)
    dot_m_P = k_R1 * m_A_R + p_1 * k_R2 * (m_A / m_ges) * m_AWT
    dot_T_R = 1. / (c_pR * m_ges) * (
        m_dot_f * c_pF * (T_F - T_R) - k_K * A_tank * (T_R - T_S)
        - fm_AWT * c_pR * (T_R - T_EK) + delH_R * k_R1 * m_A_R)
    dot_T_S = 1. / (c_pS * m_S) * (k_K * A_tank * (T_R - T_S)
                                   - k_K * A_tank * (T_S - Tout_M))
    dot_Tout_M = 1. / (c_pW * m_M_KW) * (
        fm_M_KW * c_pW * (T_in_M - Tout_M) + k_K * A_tank * (T_S - Tout_M))
    dot_T_EK = 1. / (c_pR * m_AWT) * (
        fm_AWT * c_pR * (T_R - T_EK) - alfa * (T_EK - Tout_AWT)
        + p_1 * k_R2 * (m_A / m_ges) * m_AWT * delH_R)
    dot_Tout_AWT = 1. / (c_pW * m_AWT_KW) * (
        fm_AWT_KW * c_pW * (T_in_EK - Tout_AWT) - alfa * (Tout_AWT - T_EK))
    dot_accum = m_dot_f
    dot_T_adiab = (delH_R / (m_ges * c_pR) * dot_m_A
                   - (dot_m_A + dot_m_W + dot_m_P)
                   * (m_A * delH_R / (m_ges * m_ges * c_pR)) + dot_T_R)
    return torch.stack([dot_m_W, dot_m_A, dot_m_P, dot_T_R, dot_T_S,
                        dot_Tout_M, dot_T_EK, dot_Tout_AWT, dot_accum,
                        dot_T_adiab], -1)


def lterm(x, u, p):
    return -x[..., 2]


def mterm(x, p):
    return -x[..., 2]


def nl_cons(name, x, u, p):
    raise KeyError(name)


def complete_state(x0s, delH_R=950.0):
    """T_adiab consistent with (m_W, m_A, m_P, T_R), as
    examples/industrial_poly/main.py sets it at the nominal enthalpy."""
    x0s = np.array(x0s, dtype=float)
    m_W, m_A, m_P, T_R = (x0s[:, i] for i in range(4))
    x0s[:, 9] = m_A * delH_R / ((m_W + m_A + m_P) * c_pR) + T_R
    return x0s
