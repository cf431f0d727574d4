"""The moving-horizon estimator of the PyTorch port on its own (float64,
CPU): the estimated-parameter bounds and scaling of
``tests/test_mhe_p_est_bounds.py:81-116`` and the ``opt_x_num`` view of
``tests/test_optx_view.py:89-104``, with the JAX package's layout.

Moved from ``tests/test_torch_mhe.py``: three items, so that under
``pytest -n 6 --dist loadfile`` (files ordered by their number of items)
neither file delays the JAX package's long ``tests/test_mhe_p_est_bounds.py``
more than it must.
"""
import numpy as np
import pytest
import torch

import dompc_tpu.systems as jsys
import dompc_tpu_torch as tdm
import dompc_tpu_torch.systems as tsys


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def p_est_mhe(dm, model, p_lb=None, p_ub=None, p_scaling=None):
    """tests/test_mhe_p_est_bounds.py:16-59's MHE (p_est box bounds instead
    of the example's nl_cons) in either package."""
    mhe = dm.estimator.MHE(model, ["Theta_1"])
    mhe.settings.n_horizon = 5
    mhe.settings.t_step = 0.1
    mhe.settings.store_full_solution = True
    mhe.set_default_objective(1e-4 * np.eye(8), model.tvp["P_v"],
                              model.p["P_p"])
    tvp_template = mhe.get_tvp_template()
    for k in range(5):
        tvp_template["_tvp", k, "P_v"] = np.diag(
            np.array([1.0, 1, 1, 20, 20]))
    mhe.set_tvp_fun(lambda t: tvp_template)
    p_template = mhe.get_p_template()

    def p_fun_mhe(t_now):
        p_template["P_p"] = 1.0
        p_template["Theta_2"] = 2.25e-4
        p_template["Theta_3"] = 2.25e-4
        return p_template
    mhe.set_p_fun(p_fun_mhe)
    y_template = mhe.get_y_template()

    def y_fun(t_now):
        n_steps = min(mhe.data._y.shape[0], mhe.settings.n_horizon)
        for k in range(-n_steps, 0):
            y_template["y_meas", k] = mhe.data._y[k]
        return y_template
    mhe.set_y_fun(y_fun)
    mhe.bounds["lower", "_u", "phi_m_set"] = -5
    mhe.bounds["upper", "_u", "phi_m_set"] = 5
    if p_scaling is not None:
        mhe.scaling["_p_est", "Theta_1"] = p_scaling
    if p_lb is not None:
        mhe.bounds["lower", "_p_est", "Theta_1"] = p_lb
    if p_ub is not None:
        mhe.bounds["upper", "_p_est", "Theta_1"] = p_ub
    mhe.setup()
    return mhe


@pytest.fixture(scope="module")
def plant_ys(_cpu_port):
    """tests/test_mhe_p_est_bounds.py:62-78's plant measurements (port
    Simulator, seed 7, 4 steps under a constant input)."""
    model = tsys.rotating_masses_model()
    sim = tsys.rotating_masses_simulator(model)
    sim.x0 = np.random.default_rng(7).random(model.n_x) - 0.5
    u0 = np.array([[0.5], [-0.5]])
    return model, [sim.make_step(u0) for _ in range(4)]


def p_est_run(mhe, ys):
    mhe.x0 = np.zeros(mhe.model.n_x)
    mhe.p_est0 = 1e-4
    mhe.set_initial_guess()
    est = []
    for y in ys:
        mhe.make_step(y)
        est.append(float(mhe._p_est0.data[0]))
    return np.asarray(est)


def test_p_est_bound_accessors_roundtrip(plant_ys):
    model, _ = plant_ys
    mhe = p_est_mhe(tdm, model, p_lb=1e-5, p_ub=1e-3)
    assert float(np.asarray(
        mhe.bounds["lower", "_p_est", "Theta_1"]).reshape(())) == 1e-5
    assert float(np.asarray(
        mhe.bounds["upper", "_p_est", "Theta_1"]).reshape(())) == 1e-3
    sl = mhe.layout.sl(("p_est",))
    assert np.allclose(mhe._lb_opt_x[sl], 1e-5)
    assert np.allclose(mhe._ub_opt_x[sl], 1e-3)


def test_p_est_upper_bound_clips_and_scaling_applies(plant_ys):
    """The bound clips the estimate and is active at least once; a scaled
    estimated parameter gives the same physical estimate (the JAX tests'
    bounds and tolerances; the scaling is checked on the bounded run, so
    at an active bound)."""
    model, ys = plant_ys
    free = p_est_run(p_est_mhe(tdm, model), ys)
    ub = 0.6 * float(free.max())
    bounded = p_est_run(p_est_mhe(tdm, model, p_lb=1e-6, p_ub=ub), ys)
    assert np.all(bounded <= ub * (1 + 1e-5) + 1e-12)
    assert bounded.max() > 0.5 * ub
    scaled = p_est_run(p_est_mhe(tdm, model, p_lb=1e-6, p_ub=ub,
                                 p_scaling=1e-4), ys)
    np.testing.assert_allclose(scaled, bounded, rtol=2e-3, atol=1e-8)


def test_mhe_view(plant_ys):
    model, _ = plant_ys
    mhe = tsys.rotating_masses_mhe(model)
    L = mhe.layout
    mhe.opt_x_num[:] = np.random.default_rng(0).standard_normal(L.size)
    flat = np.asarray(mhe.opt_x_num)
    np.testing.assert_array_equal(mhe.opt_x_num["_x", 1, -1],
                                  flat[L.sl(("x_node", 1, 0))])
    np.testing.assert_array_equal(mhe.opt_x_num["_p_est"],
                                  flat[L.sl(("p_est",))])
    np.testing.assert_array_equal(mhe.opt_x_num["_p_est", "Theta_1"],
                                  flat[L.sl(("p_est",))])
    np.testing.assert_array_equal(mhe.opt_x_num["_v", 2],
                                  flat[L.sl(("v", 2))])
    # the full-width layout is the JAX package's
    jmhe = jsys.rotating_masses_mhe(jsys.rotating_masses_model())
    assert jmhe.layout.offsets == L.offsets
