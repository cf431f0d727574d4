"""Lotka-Volterra with an integer input (MINLP).

Reference: examples/Lotka_Volterra/template_model.py and
examples/Lotka_Volterra/template_mpc.py (BONMIN branch-and-bound there;
batched branch-and-bound or relaxation-rounding here, see
controller/_mpc.py).  A copy of the JAX package's functions, declared
through the port's API.
"""
from .. import controller, model as model_mod


def lotka_volterra_model_integer():
    m = model_mod.Model("continuous")
    c0, c1 = 0.4, 0.2
    x_0 = m.set_variable("_x", "x_0")
    x_1 = m.set_variable("_x", "x_1")
    inp = m.set_variable("_u", "inp", input_type_integer=True)
    m.set_rhs("x_0", x_0 - x_0 * x_1 - c0 * x_0 * inp)
    m.set_rhs("x_1", -x_1 + x_0 * x_1 - c1 * x_1 * inp)
    m.setup()
    return m


def lotka_volterra_mpc(model):
    mpc = controller.MPC(model)
    s = mpc.settings
    s.n_horizon = 25
    s.n_robust = 0
    s.t_step = 0.3
    s.collocation_deg = 2
    s.collocation_ni = 2
    x_0 = model.x["x_0"]
    x_1 = model.x["x_1"]
    mterm = (x_0 - 1) ** 2 + (x_1 - 1) ** 2
    mpc.set_objective(mterm=mterm, lterm=mterm)
    mpc.set_rterm(inp=1)
    mpc.bounds["lower", "_x", "x_0"] = 0.0
    mpc.bounds["lower", "_x", "x_1"] = 0.0
    mpc.bounds["upper", "_x", "x_0"] = 2.0
    mpc.bounds["lower", "_u", "inp"] = 0.0
    mpc.bounds["upper", "_u", "inp"] = 1.0
    mpc.setup()
    return mpc
