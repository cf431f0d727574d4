"""Kite power-generation system — the reference's examples/kite.

Physics per reference examples/kite/template_model.py (Erhard-Strauch
kite model on a fixed tether: zenith/azimuth/orientation angles, tether
force aux expression); MPC/simulator tuning per the sibling templates.
A copy of the JAX package's functions, declared through the port's API.
"""
import numpy as np

import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def kite_model():
    m = dm.model.Model("continuous")
    L_tether, A, rho, beta, c_tilde = 400.0, 300.0, 1.0, 0.0, 0.028
    theta = m.set_variable("_x", "theta")
    phi = m.set_variable("_x", "phi")
    psi = m.set_variable("_x", "psi")
    u_tilde = m.set_variable("_u", "u_tilde")
    E_0 = m.set_variable("_p", "E_0")
    v_0 = m.set_variable("_p", "v_0")
    m.set_expression("E_0", E_0)
    m.set_expression("v_0", v_0)
    E = E_0 - c_tilde * u_tilde**2
    v_a = v_0 * E * sym.cos(theta)
    P_D = (rho * v_0**2) / 2.0
    T_F = (P_D * A * sym.cos(theta)**2 * (E + 1.0)
           * sym.sqrt(E**2 + 1.0)) * (
        sym.cos(theta) * np.cos(beta)
        + sym.sin(theta) * np.sin(beta) * sym.sin(phi))
    m.set_expression("T_F", T_F)
    m.set_expression("height_kite",
                     L_tether * sym.sin(theta) * sym.cos(phi))
    dphi = -v_a / (L_tether * sym.sin(theta)) * sym.sin(psi)
    m.set_rhs("theta", v_a / L_tether * (sym.cos(psi)
                                         - sym.tan(theta) / E))
    m.set_rhs("phi", dphi)
    m.set_rhs("psi", v_a / L_tether * u_tilde + dphi * sym.cos(theta))
    m.setup()
    return m


def kite_mpc(model, n_horizon=40, w_ref=8.0, E_0v=5.0, h_min=100.0):
    """Robust (3-scenario wind) tether-force-maximizing MPC with a soft
    minimum-height constraint (reference: examples/kite/template_mpc.py;
    n_horizon=80 there — default trimmed for CI time)."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.t_step = 0.15
    mpc.set_objective(mterm=sym.const(0.0), lterm=-model.aux["T_F"] / 1e4)
    mpc.set_rterm(u_tilde=0.5)
    mpc.bounds["lower", "_x", "theta"] = 0.0
    mpc.bounds["lower", "_x", "phi"] = -0.5 * np.pi
    mpc.bounds["lower", "_x", "psi"] = -1.0 * np.pi
    mpc.bounds["upper", "_x", "theta"] = 0.5 * np.pi
    mpc.bounds["upper", "_x", "phi"] = 0.5 * np.pi
    mpc.bounds["upper", "_x", "psi"] = 1.0 * np.pi
    mpc.bounds["lower", "_u", "u_tilde"] = -10
    mpc.bounds["upper", "_u", "u_tilde"] = 10
    mpc.set_nl_cons("height_kite", -model.aux["height_kite"], ub=-h_min,
                    soft_constraint=True, penalty_term_cons=1e3,
                    maximum_violation=10)
    mpc.set_uncertainty_values(
        E_0=np.array([E_0v]),
        v_0=np.array([w_ref, w_ref * 0.8, w_ref * 1.2]))
    mpc.setup()
    return mpc


def kite_simulator(model, w_ref=8.0, E_0v=5.0):
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.15, substeps=4)
    p_num = sim.get_p_template()
    p_num["E_0"] = E_0v
    p_num["v_0"] = w_ref
    sim.set_p_fun(lambda t: p_num)
    sim.setup()
    return sim
