"""Double inverted pendulum on a cart: index-1 DAE via Euler-Lagrange.

Reference: examples/double_inverted_pendulum/template_{model,mpc,
simulator}.py (DAE model, obstacle avoidance nl_cons, energy objective).
A copy of the JAX package's functions, declared through the port's API.
"""
import numpy as np

from .. import controller, model as model_mod, sym
from ..simulator import Simulator

DIP_OBSTACLES = [{"x": 0.0, "y": 0.6, "r": 0.3}]


def dip_model(obstacles=DIP_OBSTACLES):
    m = model_mod.Model("continuous")
    m0 = 0.6
    L1, L2 = 0.5, 0.5
    l1, l2 = L1 / 2, L2 / 2
    m1 = m.set_variable("_p", "m1")
    m2 = m.set_variable("_p", "m2")
    J1 = (m1 * l1**2) / 3
    J2 = (m2 * l2**2) / 3
    g = 9.80665
    h1 = m0 + m1 + m2
    h2 = m1 * l1 + m2 * L1
    h3 = m2 * l2
    h4 = m1 * l1**2 + m2 * L1**2 + J1
    h5 = m2 * l2 * L1
    h6 = m2 * l2**2 + J2
    h7 = (m1 * l1 + m2 * L1) * g
    h8 = m2 * l2 * g
    pos_set = m.set_variable("_tvp", "pos_set")
    pos = m.set_variable("_x", "pos")
    theta = m.set_variable("_x", "theta", (2, 1))
    dpos = m.set_variable("_x", "dpos")
    dtheta = m.set_variable("_x", "dtheta", (2, 1))
    ddpos = m.set_variable("_z", "ddpos")
    ddtheta = m.set_variable("_z", "ddtheta", (2, 1))
    u = m.set_variable("_u", "force")
    m.set_rhs("pos", dpos)
    m.set_rhs("theta", dtheta)
    m.set_rhs("dpos", ddpos)
    m.set_rhs("dtheta", ddtheta)
    euler_lagrange = sym.vertcat(
        h1 * ddpos + h2 * ddtheta[0] * sym.cos(theta[0])
        + h3 * ddtheta[1] * sym.cos(theta[1])
        - (h2 * dtheta[0]**2 * sym.sin(theta[0])
           + h3 * dtheta[1]**2 * sym.sin(theta[1]) + u),
        h2 * sym.cos(theta[0]) * ddpos + h4 * ddtheta[0]
        + h5 * sym.cos(theta[0] - theta[1]) * ddtheta[1]
        - (h7 * sym.sin(theta[0])
           - h5 * dtheta[1]**2 * sym.sin(theta[0] - theta[1])),
        h3 * sym.cos(theta[1]) * ddpos
        + h5 * sym.cos(theta[0] - theta[1]) * ddtheta[0] + h6 * ddtheta[1]
        - (h5 * dtheta[0]**2 * sym.sin(theta[0] - theta[1])
           + h8 * sym.sin(theta[1])),
    )
    m.set_alg("euler_lagrange", euler_lagrange)
    E_kin_cart = 0.5 * m0 * dpos**2
    E_kin_p1 = 0.5 * m1 * (
        (dpos + l1 * dtheta[0] * sym.cos(theta[0]))**2
        + (l1 * dtheta[0] * sym.sin(theta[0]))**2) + 0.5 * J1 * dtheta[0]**2
    E_kin_p2 = 0.5 * m2 * (
        (dpos + L1 * dtheta[0] * sym.cos(theta[0])
         + l2 * dtheta[1] * sym.cos(theta[1]))**2
        + (L1 * dtheta[0] * sym.sin(theta[0])
           + l2 * dtheta[1] * sym.sin(theta[1]))**2) \
        + 0.5 * J2 * dtheta[0]**2
    m.set_expression("E_kin", E_kin_cart + E_kin_p1 + E_kin_p2)
    E_pot = m1 * g * l1 * sym.cos(theta[0]) + m2 * g * (
        L1 * sym.cos(theta[0]) + l2 * sym.cos(theta[1]))
    m.set_expression("E_pot", E_pot)
    node0_x = pos
    node0_y = np.array([0])
    node1_x = node0_x + L1 * sym.sin(theta[0])
    node1_y = node0_y + L1 * sym.cos(theta[0])
    node2_x = node1_x + L2 * sym.sin(theta[1])
    node2_y = node1_y + L2 * sym.cos(theta[1])
    dists = []
    for obs in obstacles:
        d0 = sym.sqrt((node0_x - obs["x"])**2
                      + (node0_y - obs["y"])**2) - obs["r"] * 1.05
        d1 = sym.sqrt((node1_x - obs["x"])**2
                      + (node1_y - obs["y"])**2) - obs["r"] * 1.05
        d2 = sym.sqrt((node2_x - obs["x"])**2
                      + (node2_y - obs["y"])**2) - obs["r"] * 1.05
        dists.extend([d0, d1, d2])
    m.set_expression("obstacle_distance", sym.vertcat(*dists))
    m.set_expression("tvp", pos_set)
    m.setup()
    return m


def dip_mpc(model):
    mpc = controller.MPC(model)
    s = mpc.settings
    s.n_horizon = 100
    s.n_robust = 0
    s.t_step = 0.04
    s.collocation_deg = 3
    s.collocation_ni = 1
    s.store_full_solution = True
    # the cold swing-up solve takes ~160-230 filter iterations (IPOPT's
    # default max_iter is 3000); warm steps certify in 12-17
    s.solver_max_iter = 300
    mterm = model.aux["E_kin"] - model.aux["E_pot"]
    lterm = -model.aux["E_pot"] \
        + 10 * (model.x["pos"] - model.tvp["pos_set"])**2
    mpc.set_objective(mterm=mterm, lterm=lterm)
    mpc.set_rterm(force=0.1)
    mpc.bounds["lower", "_u", "force"] = -4
    mpc.bounds["upper", "_u", "force"] = 4
    mpc.set_nl_cons("obstacles", -model.aux["obstacle_distance"], 0)
    mpc.set_uncertainty_values(m1=0.2 * np.array([1, 0.95, 1.05]),
                               m2=0.2 * np.array([1, 0.95, 1.05]))
    tvp_template = mpc.get_tvp_template()
    t_switch = 4
    ind_switch = t_switch // s.t_step

    def tvp_fun(t_ind):
        ind = t_ind // s.t_step
        val = -0.8 if ind <= ind_switch else 0.8
        for k in range(s.n_horizon + 1):
            tvp_template["_tvp", k, "pos_set"] = val
        return tvp_template
    mpc.set_tvp_fun(tvp_fun)
    mpc.setup()
    return mpc


def dip_simulator(model):
    sim = Simulator(model)
    sim.set_param(integration_tool="idas", abstol=1e-8, reltol=1e-8,
                  t_step=0.04, substeps=4)
    p_num = sim.get_p_template()
    p_num["m1"] = 0.2
    p_num["m2"] = 0.2
    sim.set_p_fun(lambda t: p_num)
    tvp_template = sim.get_tvp_template()
    sim.set_tvp_fun(lambda t: tvp_template)
    sim.setup()
    return sim
