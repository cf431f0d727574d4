"""Linear models and the LQR of the PyTorch port against the JAX package
(float64, CPU).

The flows of the JAX package's own tests, each built once per package
from the same construction code and run side by side:

* (in ``tests/test_torch_lqr_loops.py``, with this file's helpers) the
  CSTR LQR (``tests/test_more_examples.py:95-125``: ``linearize`` at the
  steady state, ``discretize``, a finite-horizon LQR with input-rate
  penalty, an adaptive ``Simulator`` plant), cut from 200 to 5 steps, and
  the batch reactor (``tests/test_more_examples.py:128-163``:
  ``dae2odeconversion`` -> ``linearize`` -> ``discretize`` -> LQR, the
  plant the continuous linear model), cut from 50 to 10 steps;
* ``LinearModel.setup(A, B)`` and ``discretize``
  (``tests/test_model_simulator.py:118-131``);
* the oscillating masses' infinite-horizon LQR (``tests/test_ekf_lqr.py:
  103-131``: the DARE gain by doubling, a discrete plant), 50 steps;
* (in ``tests/test_torch_lqr_loops.py``) ``dae2odeconversion`` of the
  double inverted pendulum (parameters, time-varying parameters, vector
  states): the right-hand side and its Jacobians at a seeded point;
* the classic systems (CSTR, batch reactor, Lotka-Volterra): the models'
  Jacobians and the MPCs' transcriptions.

System matrices, gains, inputs and states within 1e-10 relative: the
Jacobians come from two autodiff systems and the plants from two
integrators, so they differ by rounding only.
"""
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu_torch as tdm


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def _cstr_lqr_models(dm):
    """tests/test_more_examples.py:_cstr_lqr_models, for either package."""
    sym = dm.sym
    m = dm.model.Model("continuous")
    K0_1 = K0_2 = 2.145e10
    E_R_1 = E_R_2 = 9758.3
    delH_R_1, del_H_R_2 = -4200, -11000
    T_in, rho, cp, cp_J = 387.05, 934.2, 3.01, 2
    m_j, kA, C_ain, V = 5, 14.448, 5.1, 0.01
    C_a = m.set_variable("_x", "C_a")
    C_b = m.set_variable("_x", "C_b")
    T_R = m.set_variable("_x", "T_R")
    T_J = m.set_variable("_x", "T_J")
    F = m.set_variable("_u", "F")
    Q_J = m.set_variable("_u", "Q_J")
    r_1 = K0_1 * sym.exp((-E_R_1) / T_R) * C_a
    r_2 = K0_2 * sym.exp((-E_R_2) / T_R) * C_b
    m.set_expression("r", sym.vertcat(r_1, r_2))
    m.set_rhs("C_a", (F / V) * (C_ain - C_a) - r_1)
    m.set_rhs("C_b", -(F / V) * C_b + r_1 - r_2)
    m.set_rhs("T_R", (F / V) * (T_in - T_R)
              - (kA / (rho * cp * V)) * (T_R - T_J)
              + (1 / (rho * cp)) * ((delH_R_1 * (-r_1))
                                    + (del_H_R_2 * (-r_2))))
    m.set_rhs("T_J", (1 / (m_j * cp_J)) * (-Q_J + kA * (T_R - T_J)))
    m.setup()
    uss = np.array([[0.002365], [18.5583]])
    xss = np.array([[1.6329], [1.1101], [398.6581], [397.3736]])
    return m, dm.model.linearize(m, xss, uss), xss, uss


def _cstr_lqr_loop(dm, n_steps):
    model, lin, xss, uss = _cstr_lqr_models(dm)
    model_dc = lin.discretize(0.5)
    lqr = dm.controller.LQR(model_dc)
    lqr.set_param(n_horizon=10, t_step=0.5)
    lqr.set_objective(Q=10 * np.diag([1, 1, 0.01, 0.01]),
                      R=np.diag([1e-1, 1e-5]))
    lqr.set_rterm(delR=np.diag([1e8, 1.0]))
    lqr.setup()
    sim = dm.Simulator(model)
    sim.set_param(integration_tool="cvodes", abstol=1e-10, reltol=1e-10,
                  t_step=0.5, substeps=8)
    sim.setup()
    x0 = np.array([0, 0, 387.05, 387.05]).reshape(-1, 1)
    sim.x0 = x0
    lqr.set_setpoint(xss=xss, uss=uss)
    for _ in range(n_steps):
        x0 = sim.make_step(lqr.make_step(x0))
    return lin, model_dc, lqr, sim


def _batch_reactor_lqr_loop(dm, n_steps):
    """tests/test_more_examples.py:test_batch_reactor_lqr_dae's flow, for
    either package: returns (converted model, linear model, LQR,
    Simulator)."""
    m = dm.model.Model("continuous")
    k1, k2, k3 = 25, 1, 1
    Ca = m.set_variable("_x", "Ca")
    Cb = m.set_variable("_x", "Cb")
    Ad = m.set_variable("_x", "Ad")
    Cain = m.set_variable("_u", "Cain")
    Cc = m.set_variable("_z", "Cc")
    m.set_rhs("Ca", -k1 * Ca + Cain)
    m.set_rhs("Cb", k1 * Ca - k2 * Cb + k3 * Cc)
    m.set_rhs("Ad", Cain)
    m.set_alg("exp", 1 + Ad - Ca - Cb - Cc)
    m.setup()
    daemodel = dm.model.dae2odeconversion(m)
    linearmodel = dm.model.linearize(daemodel)
    model_dc = linearmodel.discretize(0.5)
    lqr = dm.controller.LQR(model_dc)
    lqr.set_param(n_horizon=10, t_step=0.5)
    lqr.set_objective(Q=10 * np.identity(5), R=5 * np.identity(1))
    lqr.setup()
    sim = dm.Simulator(linearmodel)
    sim.set_param(integration_tool="cvodes", t_step=0.5, substeps=8)
    sim.setup()
    x0 = np.array([[1.0], [0.0], [0.0], [0.0], [0.0]])
    sim.x0 = x0
    xss = np.array([[0.0], [2.0], [3.0], [0.0], [2.0]])
    lqr.set_setpoint(xss=xss, uss=model_dc.get_steady_state(xss=xss))
    for _ in range(n_steps):
        x0 = sim.make_step(lqr.make_step(x0))
    return daemodel, linearmodel, lqr, sim


def _same_loop(j, t, lqr_j, lqr_t, sim_j, sim_t):
    for name in ("sys_A", "sys_B", "sys_C", "sys_D"):
        assert _rel(getattr(t, name), getattr(j, name)) <= TOL, name
    assert _rel(lqr_t.K, lqr_j.K) <= TOL
    for attr in ("_x", "_u", "_time"):
        assert _rel(getattr(sim_t.data, attr),
                    getattr(sim_j.data, attr)) <= TOL, attr
        assert _rel(getattr(lqr_t.data, attr),
                    getattr(lqr_j.data, attr)) <= TOL, attr


def test_linear_model_and_discretize_matches_jax():
    A = np.array([[0.0, 1.0], [-2.0, -0.5]])
    B = np.array([[0.0], [1.0]])
    out = []
    for dm in (jdm, tdm):
        lm = dm.model.LinearModel("continuous")
        lm.set_variable("_x", "x", (2, 1))
        lm.set_variable("_u", "u", (1, 1))
        lm.setup(A, B)
        out.append((lm, lm.discretize(0.1)))
    (lm_j, d_j), (lm_t, d_t) = out
    np.testing.assert_allclose(lm_t.sys_A, A, atol=1e-12)
    assert _rel(d_t.sys_A, d_j.sys_A) <= TOL
    assert _rel(d_t.sys_B, d_j.sys_B) <= TOL
    assert _rel(lm_t.get_steady_state(uss=np.ones(1)),
                lm_j.get_steady_state(uss=np.ones(1))) <= TOL
    with pytest.raises(RuntimeError):
        lm_t.set_alg("z", 0)


def test_oscillating_masses_dare_lqr_matches_jax():
    A = np.array([[0.763, 0.460, 0.115, 0.020],
                  [-0.899, 0.763, 0.420, 0.115],
                  [0.115, 0.020, 0.763, 0.460],
                  [0.420, 0.115, -0.899, 0.763]])
    B = np.array([[0.014], [0.063], [0.221], [0.367]])
    runs = []
    for dm in (jdm, tdm):
        lm = dm.model.LinearModel("discrete")
        lm.set_variable("_x", "x", (4, 1))
        lm.set_variable("_u", "u", (1, 1))
        lm.setup(A, B)
        lqr = dm.controller.LQR(lm)
        lqr.settings.t_step = 0.5
        lqr.settings.n_horizon = None
        lqr.set_objective(Q=np.identity(4), R=np.identity(1))
        lqr.set_rterm(delR=np.identity(1))
        lqr.setup()
        sim = dm.Simulator(lm)
        sim.set_param(t_step=0.5)
        sim.setup()
        x0 = np.array([[2], [1], [3], [1]])
        sim.x0 = x0
        for _ in range(50):
            x0 = sim.make_step(lqr.make_step(x0))
        runs.append((lm, lqr, sim))
    (lm_j, lqr_j, sim_j), (lm_t, lqr_t, sim_t) = runs
    # the infinite-horizon gain solves the DARE of the rate-augmented system
    import scipy.linalg
    P = scipy.linalg.solve_discrete_are(lqr_t.A_rated, lqr_t.B_rated,
                                        lqr_t.Q, lqr_t.R)
    Bt = lqr_t.B_rated
    K = -np.linalg.solve(Bt.T @ P @ Bt + lqr_t.R, Bt.T @ P @ lqr_t.A_rated)
    assert _rel(lqr_t.K, K) <= 1e-8
    _same_loop(lm_j, lm_t, lqr_j, lqr_t, sim_j, sim_t)


@pytest.mark.parametrize("name,has_mpc", [("cstr", True),
                                          ("batch_reactor", True),
                                          ("lotka_volterra", False)])
def test_classic_systems_match_jax(name, has_mpc):
    """The classic systems the linear flows draw on (``systems._classic``):
    each model's Jacobians at a seeded operating point and, where the
    package has one, its MPC's transcription (layout size and the bounds
    of every decision variable)."""
    import dompc_tpu.systems as jsys
    import dompc_tpu_torch.systems as tsys
    models = [getattr(sysmod, f"{name}_model")() for sysmod in (jsys, tsys)]
    rng = np.random.default_rng(len(name))
    point = [np.abs(rng.standard_normal(n)) + 0.5 for n in
             (models[0].n_x, models[0].n_u)]
    p = np.ones(models[0].n_p)
    for j, t in zip(models[0].get_linear_system_matrices(*point, pss=p),
                    models[1].get_linear_system_matrices(*point, pss=p)):
        assert _rel(t, j) <= TOL
    if has_mpc:
        mj, mt = (getattr(sysmod, f"{name}_mpc")(m)
                  for sysmod, m in zip((jsys, tsys), models))
        assert mt.n_opt_x == mj.n_opt_x
        for attr in ("_lb_opt_x", "_ub_opt_x"):
            np.testing.assert_array_equal(np.asarray(getattr(mt, attr)),
                                          np.asarray(getattr(mj, attr)))
