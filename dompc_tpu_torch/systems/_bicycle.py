"""Kinematic and dynamic bicycle-model vehicle systems.

Physics per the reference's examples/kinematic_bicycle_model/
template_model.py (Chronos/CRS miniature car, slip-angle kinematics) and
examples/dynamic_bicycle_model/template_model.py (Pacejka-tire scale
racing vehicle, Cataffo et al. 2022); MPC/simulator tuning per the
sibling template_mpc.py / template_simulator.py. A copy of the JAX package's
functions, declared through the port's API.
"""
import numpy as np

import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def kinematic_bicycle_model():
    """4-state car: position (X_p, Y_p), yaw Psi, speed V; inputs are
    steering angle Delta and acceleration Acc (reference:
    examples/kinematic_bicycle_model/template_model.py:44-74)."""
    m = dm.model.Model("continuous")
    lf, lr = 0.3, 0.3
    X_p = m.set_variable("_x", "X_p")
    Y_p = m.set_variable("_x", "Y_p")
    Psi = m.set_variable("_x", "Psi")
    V = m.set_variable("_x", "V")
    Delta = m.set_variable("_u", "Delta")
    Acc = m.set_variable("_u", "Acc")
    beta = sym.atan((lr / (lr + lf)) * sym.tan(Delta))
    m.set_rhs("X_p", V * sym.cos(Psi + beta))
    m.set_rhs("Y_p", V * sym.sin(Psi + beta))
    m.set_rhs("Psi", (V / lr) * sym.sin(beta))
    m.set_rhs("V", Acc)
    m.setup()
    return m


def kinematic_bicycle_mpc(model, n_horizon=10):
    """Drive to (X_p, Y_p) = (3, 2) at zero heading (reference:
    examples/kinematic_bicycle_model/template_mpc.py:45-90)."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.t_step = 0.05
    s.store_full_solution = True
    x = model.x
    mterm = ((x["Y_p"] - 2) ** 2 + (x["X_p"] - 3) ** 2 + x["Psi"] ** 2)
    mpc.set_objective(mterm=mterm, lterm=0 * (x["Y_p"] - 1) ** 2)
    mpc.set_rterm(Delta=1.0, Acc=1e-3)
    for nm, lo, hi in (("X_p", -50, 50), ("Y_p", -50, 50),
                       ("Psi", -np.pi / 2, np.pi / 2), ("V", -5, 5)):
        mpc.bounds["lower", "_x", nm] = lo
        mpc.bounds["upper", "_x", nm] = hi
    for nm in ("Delta", "Acc"):
        mpc.bounds["lower", "_u", nm] = -5
        mpc.bounds["upper", "_u", nm] = 5
    mpc.setup()
    return mpc


def kinematic_bicycle_simulator(model):
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.05, substeps=2)
    sim.setup()
    return sim


def dynamic_bicycle_model():
    """6-state scale racing car with Pacejka lateral tire forces and a
    PWM-driven longitudinal force map (reference:
    examples/dynamic_bicycle_model/template_model.py:46-101)."""
    m = dm.model.Model("continuous")
    mass, I_z = 5.692, 0.204
    lf, lr = 0.178, 0.147
    D_f, D_r = 134.585, 159.919
    C_f, C_r = 0.085, 0.133
    B_f, B_r = 9.242, 17.716
    c_m1, c_m2, c_m3, c_m4 = 20.0, 6.92e-7, 3.99, 0.67
    X_p = m.set_variable("_x", "X_p")
    Y_p = m.set_variable("_x", "Y_p")
    Psi = m.set_variable("_x", "Psi")
    V_x = m.set_variable("_x", "V_x")
    V_y = m.set_variable("_x", "V_y")
    W = m.set_variable("_x", "W")
    Delta = m.set_variable("_u", "Delta")
    d = m.set_variable("_u", "d")
    m.set_expression("Vel", sym.sqrt(V_x**2 + V_y**2))
    alpha_f = -sym.atan2(W * lf + V_y, V_x) + Delta
    alpha_r = sym.atan2(W * lr - V_y, V_x)
    F_f_y = D_f * sym.sin(C_f * sym.atan(B_f * alpha_f))
    F_r_y = D_r * sym.sin(C_r * sym.atan(B_r * alpha_r))
    F_x = (c_m1 - c_m2 * V_x) * d - c_m4 * V_x**2 - c_m3
    m.set_rhs("X_p", V_x * sym.cos(Psi) - V_y * sym.sin(Psi))
    m.set_rhs("Y_p", V_x * sym.sin(Psi) + V_y * sym.cos(Psi))
    m.set_rhs("Psi", W)
    m.set_rhs("V_x", (F_x - F_f_y * sym.sin(Delta) + mass * V_y * W) / mass)
    m.set_rhs("V_y", (F_r_y + F_f_y * sym.cos(Delta) - mass * V_x * W)
              / mass)
    m.set_rhs("W", (F_f_y * lf * sym.cos(Delta) - lf * F_x * sym.sin(Delta)
                    - lr * F_r_y) / I_z)
    m.setup()
    return m


def dynamic_bicycle_mpc(model, n_horizon=10):
    """Track lateral setpoint Y_p = 1 (reference:
    examples/dynamic_bicycle_model/template_mpc.py:42-93)."""
    mpc = dm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.t_step = 0.1
    s.store_full_solution = True
    track = (model.x["Y_p"] - 1.0) ** 2
    mpc.set_objective(mterm=track, lterm=track)
    mpc.set_rterm(Delta=1e-3, d=1e-3)
    for nm, lo, hi in (("X_p", -50000, 50000), ("Y_p", -2, 2),
                       ("Psi", -0.78, 0.78), ("V_x", 0.1, 5),
                       ("V_y", -1, 1), ("W", -0.2, 0.2)):
        mpc.bounds["lower", "_x", nm] = lo
        mpc.bounds["upper", "_x", nm] = hi
    mpc.bounds["lower", "_u", "Delta"] = -2
    mpc.bounds["upper", "_u", "Delta"] = 2
    mpc.bounds["lower", "_u", "d"] = 0
    mpc.bounds["upper", "_u", "d"] = 1
    mpc.setup()
    return mpc


def dynamic_bicycle_simulator(model):
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.1, substeps=4)
    sim.setup()
    return sim
