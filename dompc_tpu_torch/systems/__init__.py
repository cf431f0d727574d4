"""Benchmark systems (PyTorch port): the flagship robust multi-stage CSTR
NMPC, built through the same public API as the JAX package's
``__graft_entry__._build_cstr_mpc``, and copies of the JAX package's
systems: oscillating masses, the CSTR model, MPC and simulator, the
batch reactor, Lotka-Volterra, the triple tank, the rotating masses of the
coupled MHE + MPC loop, and the double inverted pendulum (a DAE)."""
import numpy as np

from ._classic import (oscillating_masses_model,  # noqa: F401
                       oscillating_masses_mpc, cstr_model, cstr_mpc,
                       cstr_simulator, batch_reactor_model,
                       batch_reactor_mpc, lotka_volterra_model)
from ._triple_tank import triple_tank_model  # noqa: F401
from ._dip import (dip_model, dip_mpc, dip_simulator,  # noqa: F401
                   DIP_OBSTACLES)
from ._rotating_masses import (rotating_masses_model,  # noqa: F401
                               rotating_masses_mpc,
                               rotating_masses_simulator,
                               rotating_masses_mhe)


def cstr_robust_mpc(n_horizon=20, n_robust=1, kkt_solver="auto",
                    max_iter=150):
    """Robust multi-stage CSTR NMPC: nx=4, nu=2, two uncertain parameters
    with three values each (a 9-branch scenario tree), Radau collocation of
    degree 2, soft upper bound on the reactor temperature.  Returns the
    set-up :class:`~dompc_tpu_torch.controller.MPC`; device and dtype come
    from the environment at ``setup()``."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch import sym

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

    mpc = dm.controller.MPC(m)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.n_robust = n_robust
    s.t_step = 0.005
    s.kkt_solver = kkt_solver
    s.solver_max_iter = max_iter
    mpc.scaling["_x", "T_R"] = 100
    mpc.scaling["_x", "T_K"] = 100
    mpc.scaling["_u", "Q_dot"] = 2000
    mpc.scaling["_u", "F"] = 100
    mpc.set_objective(mterm=(m.x["C_b"] - 0.6) ** 2,
                      lterm=(m.x["C_b"] - 0.6) ** 2)
    mpc.set_rterm(F=0.1, Q_dot=1e-3)
    for nm, lo, hi in (("C_a", 0.1, 2), ("C_b", 0.1, 2), ("T_R", 50, None),
                       ("T_K", 50, 140)):
        mpc.bounds["lower", "_x", nm] = lo
        if hi is not None:
            mpc.bounds["upper", "_x", nm] = hi
    mpc.bounds["lower", "_u", "F"] = 5
    mpc.bounds["upper", "_u", "F"] = 100
    mpc.bounds["lower", "_u", "Q_dot"] = -8500
    mpc.bounds["upper", "_u", "Q_dot"] = 0.0
    mpc.set_nl_cons("T_R", m.x["T_R"], ub=140, soft_constraint=True,
                    penalty_term_cons=1e2)
    mpc.set_uncertainty_values(alpha=np.array([1.0, 1.05, 0.95]),
                               beta=np.array([1.0, 1.1, 0.9]))
    mpc.setup()
    return mpc


CSTR_X0 = np.array([0.8, 0.5, 134.14, 130.0])


def bench_states(B, seed=0):
    """B plant states for batched serving, as the JAX package's bench.py
    draws them (l.39-46): 2 % noise around ``CSTR_X0``, clipped."""
    rng = np.random.default_rng(seed)
    x0s = CSTR_X0[None, :] * (1.0 + 0.02 * rng.standard_normal((B, 4)))
    return np.clip(x0s, [0.15, 0.15, 55, 55], [1.9, 1.9, 139.5, 139.5])
