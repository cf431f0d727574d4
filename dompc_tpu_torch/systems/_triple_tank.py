"""Triple-tank system (discrete) — the reference's EKF example.

Physics per reference examples/triple_tank_ekf/template_model.py (three
coupled tanks, sign/sqrt orifice flows, one measured level).  A copy of
the JAX package's function, declared through the port's API.
"""
import dompc_tpu_torch as dm
from dompc_tpu_torch import sym


def triple_tank_model():
    m = dm.model.Model("discrete")
    x1 = m.set_variable("_x", "x1")
    x2 = m.set_variable("_x", "x2")
    x3 = m.set_variable("_x", "x3")
    u1 = m.set_variable("_u", "u1")
    u2 = m.set_variable("_u", "u2")
    m.set_meas("x3_meas", x3)
    p1 = m.set_variable("_p", "p1")
    tvp1 = m.set_variable("_tvp", "tvp1")
    A, g, Ts = 0.00154, 9.81, 1
    r1, r2, r3, sp = 1, 0.8, 1, 5e-5
    q13 = r1 * sp * sym.sign(x1 - x3) * sym.sqrt(2 * g * sym.fabs(x1 - x3))
    q32 = r3 * sp * sym.sign(x3 - x2) * sym.sqrt(2 * g * sym.fabs(x3 - x2))
    q20 = r2 * sp * sym.sqrt(2 * g * x2) * tvp1 * p1
    m.set_rhs("x1", x1 + (Ts / A) * (-q13 + u1))
    m.set_rhs("x2", x2 + (Ts / A) * (q32 - q20 + u2))
    m.set_rhs("x3", x3 + (Ts / A) * (q13 - q32))
    m.setup()
    return m
