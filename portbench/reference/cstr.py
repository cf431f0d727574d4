"""do-mpc's CSTR (examples/CSTR/template_model.py, template_mpc.py): a
continuously stirred tank reactor with the series reaction A -> B -> C and
the side reaction 2A -> D (van de Vusse), states (C_a, C_b, T_R, T_K),
inputs (F, Q_dot), uncertain parameters (alpha, beta) scaling the side
reaction's activation energy and the first reaction's rate.

Plain PyTorch on unscaled tensors whose last axis holds the variables in
that order; any leading axes broadcast."""
import torch

K0_ab, K0_bc, K0_ad = 1.287e12, 1.287e12, 9.043e9
E_A_ab, E_A_bc, E_A_ad = 9758.3, 9758.3, 8560.0
H_R_ab, H_R_bc, H_R_ad = 4.2, -11.0, -41.85
Rou, Cp, Cp_k = 0.9342, 3.01, 2.0
A_R, V_R, m_k = 0.215, 10.01, 5.0
T_in, K_w = 130.0, 4032.0
C_A0 = (5.7 + 4.5) / 2.0


def rhs(x, u, p):
    C_a, C_b, T_R, T_K = x.unbind(-1)
    F, Q_dot = u.unbind(-1)
    alpha, beta = p.unbind(-1)
    K_1 = beta * K0_ab * torch.exp(-E_A_ab / (T_R + 273.15))
    K_2 = K0_bc * torch.exp(-E_A_bc / (T_R + 273.15))
    K_3 = K0_ad * torch.exp(-alpha * E_A_ad / (T_R + 273.15))
    T_dif = T_R - T_K
    dC_a = F * (C_A0 - C_a) - K_1 * C_a - K_3 * C_a ** 2
    dC_b = -F * C_b + K_1 * C_a - K_2 * C_b
    dT_R = ((K_1 * C_a * H_R_ab + K_2 * C_b * H_R_bc
             + K_3 * C_a ** 2 * H_R_ad) / (-Rou * Cp)
            + F * (T_in - T_R) + (K_w * A_R * (-T_dif)) / (Rou * Cp * V_R))
    dT_K = (Q_dot + K_w * A_R * T_dif) / (m_k * Cp_k)
    return torch.stack([dC_a, dC_b, dT_R, dT_K], -1)


def lterm(x, u, p):
    return (x[..., 1] - 0.6) ** 2


def mterm(x, p):
    return (x[..., 1] - 0.6) ** 2


def nl_cons(name, x, u, p):
    if name == "T_R":
        return x[..., 2]
    raise KeyError(name)


def complete_state(x0s):
    """Every CSTR state is independent: nothing to derive."""
    return x0s
