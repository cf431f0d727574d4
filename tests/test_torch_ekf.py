"""The extended Kalman filter of the PyTorch port against the JAX package's
(float64, CPU).

* the triple-tank loop of ``tests/test_ekf_lqr.py:18-51`` (discrete
  plant and filter, seeded measurement noise), 30 steps: the estimate and
  the plant within 1e-9, with the same ``Data`` logs;
* a port Simulator and EKF continue from the JAX pair's state
  (``interop.load_loop_state``);
* the semantics of ``test_ekf_adaptive_tolerance_sweep``
  (``tests/test_ekf_lqr.py:85-100``) on the port alone.

The continuous CSTR EKF is in ``tests/test_torch_ekf_continuous.py``.
"""
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems as jsys
import dompc_tpu_torch as tdm
import dompc_tpu_torch.systems as tsys
from dompc_tpu_torch.interop import load_loop_state, loop_state_arrays


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def _tank_tvp_fun(tmpl):
    def tvp_fun(t_now):
        tmpl["tvp1"] = 0.5 if t_now < 50 else 1.0
        return tmpl
    return tvp_fun


def tank_loop(dm, systems, n_steps, seed=42):
    """The triple-tank Simulator + EKF loop (tests/test_ekf_lqr.py:18-51)
    with its seeded measurement noise."""
    model = systems.triple_tank_model()
    sim = dm.Simulator(model)
    sim.set_param(t_step=1)
    p_t = sim.get_p_template()
    p_t["p1"] = 2
    sim.set_p_fun(lambda t: p_t)
    sim.set_tvp_fun(_tank_tvp_fun(sim.get_tvp_template()))
    sim.setup()
    ekf = dm.estimator.EKF(model)
    ekf.settings.t_step = 1
    p_te = ekf.get_p_template()
    p_te["p1"] = 2
    ekf.set_p_fun(lambda t: p_te)
    ekf.set_tvp_fun(_tank_tvp_fun(ekf.get_tvp_template()))
    ekf.setup()
    sim.x0 = np.array([2, 2.8, 2.7])
    ekf.x0 = np.array([1.2, 1.4, 1.8])
    sim.set_initial_guess()
    ekf.set_initial_guess()
    tank_steps(sim, ekf, n_steps, np.random.default_rng(seed))
    return sim, ekf


def tank_steps(sim, ekf, n_steps, rng):
    model = sim.model
    Q = np.diag(1e-3 * np.ones(model.n_x))
    R = np.diag(1e-2 * np.ones(model.n_y))
    u0 = np.array([[0.0001], [0.0001]])
    for _ in range(n_steps):
        y_next = sim.make_step(u0, v0=0.001 * rng.standard_normal(
            (model.n_v, 1)))
        ekf.make_step(y_next=y_next, u_next=u0, Q_k=Q, R_k=R)


def test_triple_tank_ekf_loop_matches_jax():
    sim_j, ekf_j = tank_loop(jdm, jsys, 30)
    sim_t, ekf_t = tank_loop(tdm, tsys, 30)
    for mine, ref in ((sim_t.data, sim_j.data), (ekf_t.data, ekf_j.data)):
        for field in ("_x", "_u", "_y", "_time", "_tvp", "_p"):
            a, b = getattr(mine, field), getattr(ref, field)
            assert a.shape == b.shape, field
            assert _rel(a, b) <= 1e-9, (field, _rel(a, b))
    assert _rel(ekf_t.P0, ekf_j.P0) <= 1e-9
    # the filter converges toward the plant
    assert np.max(np.abs(ekf_t.data._x[-1] - sim_t.data._x[-1])) < 0.5


def test_loop_state_loads_from_jax():
    """``interop.load_loop_state``: a port Simulator and EKF started from
    the JAX pair's state after 12 steps continue as the JAX pair does."""
    sim_j, ekf_j = tank_loop(jdm, jsys, 12)
    sim_t, ekf_t = tank_loop(tdm, tsys, 0)
    for port, ref in ((sim_t, sim_j), (ekf_t, ekf_j)):
        load_loop_state(port, loop_state_arrays(ref))
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    tank_steps(sim_j, ekf_j, 4, rng_j)
    tank_steps(sim_t, ekf_t, 4, rng_t)
    for port, ref in ((sim_t, sim_j), (ekf_t, ekf_j)):
        for key, val in loop_state_arrays(ref).items():
            assert _rel(loop_state_arrays(port)[key], val) <= 1e-9, key
    assert _rel(ekf_t.data._x, ekf_j.data._x[-4:]) <= 1e-9
    assert _rel(sim_t.data._y, sim_j.data._y[-4:]) <= 1e-9


def _run_ekf_steps(abstol, reltol, adaptive=True, substeps=4, n_steps=15):
    model = tsys.triple_tank_model()
    ekf = tdm.estimator.EKF(model)
    ekf.settings.t_step = 1
    ekf.settings.adaptive = adaptive
    ekf.settings.abstol = abstol
    ekf.settings.reltol = reltol
    ekf.settings.substeps = substeps
    p_te = ekf.get_p_template()
    p_te["p1"] = 2
    ekf.set_p_fun(lambda t: p_te)
    ekf.set_tvp_fun(_tank_tvp_fun(ekf.get_tvp_template()))
    ekf.setup()
    Q = np.diag(1e-3 * np.ones(model.n_x))
    R = np.diag(1e-2 * np.ones(model.n_y))
    ekf.x0 = np.array([1.2, 1.4, 1.8])
    ekf.set_initial_guess()
    rng = np.random.default_rng(7)
    u0 = np.array([[0.0001], [0.0001]])
    for _ in range(n_steps):
        y = 2.0 + 0.01 * rng.standard_normal(model.n_y)
        ekf.make_step(y_next=y, u_next=u0, Q_k=Q, R_k=R)
    return np.asarray(ekf.data._x)


def test_ekf_adaptive_tolerance_sweep():
    """The port's counterpart of JAX's test of the same name: tightening
    the tolerance converges toward a tight reference, and the fixed-substep
    mode stays close."""
    x_ref = _run_ekf_steps(1e-12, 1e-12)
    errs = [np.max(np.abs(_run_ekf_steps(tol, tol) - x_ref))
            for tol in (1e-2, 1e-6, 1e-10)]
    assert errs[1] <= errs[0] + 1e-14
    assert errs[2] <= 1e-9, f"tight-tol error {errs[2]:.2e}"
    assert errs[0] < 1e-2
    x_fixed = _run_ekf_steps(1e-10, 1e-10, adaptive=False, substeps=8)
    assert np.max(np.abs(x_fixed - x_ref)) < 1e-5
