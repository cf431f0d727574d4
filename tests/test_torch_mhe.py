"""The moving-horizon estimator of the PyTorch port against the JAX
package's (float64, CPU).

* the oracles f, g, h, grad_f, jac_g, jac_h and the Lagrangian Hessian of
  the trimmed rotating-masses MHE of ``tests/test_mhe_structured_kkt.py``
  (its N=6) at a seeded point: within 1e-12;
* three ``make_step`` calls on that file's seeded measurements
  (``run_loop``) with the dense KKT and with the bordered-band KKT
  (``kkt_solver="tridiag"``: the estimated parameter in the root border,
  the chain sweep through ``band_qr.band_solve``): each within 1e-8 of the
  JAX MHE at equal iterations, and the port's two backends within the JAX
  test's own 1e-6.  The JAX side runs the dense backend only: that file
  holds JAX's two backends to each other, and a second JAX solver would
  double this file's compile time;
* a port MHE that continues from the JAX MHE's numeric state
  (``interop.load_mhe_state``) takes JAX's next step;
* the estimated-parameter bounds and scaling of
  ``tests/test_mhe_p_est_bounds.py:81-116`` and the ``opt_x_num`` view of
  ``tests/test_optx_view.py:89-104``, on the port.
"""
import jax
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems as jsys
import dompc_tpu_torch as tdm
import dompc_tpu_torch.systems as tsys
from dompc_tpu_torch.interop import load_mhe_state, mhe_state_arrays
from dompc_tpu_torch.solver import band_qr

N_TRIM = 6      # tests/test_mhe_structured_kkt.py:48


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


def small_masses_model(dm):
    """The trimmed rotating-masses model of
    tests/test_mhe_structured_kkt.py:16-43, in either package."""
    sym = dm.sym
    m = dm.model.Model("continuous")
    phi_1 = m.set_variable("_x", "phi_1")
    phi_2 = m.set_variable("_x", "phi_2")
    phi_3 = m.set_variable("_x", "phi_3")
    phi = sym.vertcat(phi_1, phi_2, phi_3)
    dphi = m.set_variable("_x", "dphi", shape=(3, 1))
    phi_m_set = m.set_variable("_u", "phi_m_set", shape=(2, 1))
    phi_m = m.set_variable("_x", "phi_m", shape=(2, 1))
    m.set_meas("phi_meas", phi)
    m.set_meas("phi_m_set_meas", phi_m_set)
    Theta_1 = m.set_variable("_p", "Theta_1")
    c = np.array([2.697, 2.66, 3.05, 2.86]) * 1e-3
    d = np.array([6.78, 8.01, 8.82]) * 1e-5
    Th = 2.25e-4
    m.set_rhs("phi_1", dphi[0])
    m.set_rhs("phi_2", dphi[1])
    m.set_rhs("phi_3", dphi[2])
    m.set_rhs("dphi", sym.vertcat(
        -c[0] / Theta_1 * (phi[0] - phi_m[0])
        - c[1] / Theta_1 * (phi[0] - phi[1]) - d[0] / Theta_1 * dphi[0],
        -c[1] / Th * (phi[1] - phi[0])
        - c[2] / Th * (phi[1] - phi[2]) - d[1] / Th * dphi[1],
        -c[2] / Th * (phi[2] - phi[1])
        - c[3] / Th * (phi[2] - phi_m[1]) - d[2] / Th * dphi[2]))
    m.set_rhs("phi_m", 1e2 * (phi_m_set - phi_m))
    m.setup()
    return m


def build_mhe(dm, model, kkt_solver, n_horizon=N_TRIM):
    """tests/test_mhe_structured_kkt.py:46-62's MHE in either package."""
    mhe = dm.estimator.MHE(model, ["Theta_1"])
    mhe.settings.n_horizon = n_horizon
    mhe.settings.t_step = 0.1
    mhe.settings.kkt_solver = kkt_solver
    mhe.set_default_objective(1e-4 * np.eye(model.n_x),
                              np.diag(np.array([1.0, 1, 1, 20, 20])),
                              np.array([[1.0]]))
    mhe.bounds["lower", "_u", "phi_m_set"] = -5
    mhe.bounds["upper", "_u", "phi_m_set"] = 5
    mhe.bounds["lower", "_x", "dphi"] = -6
    mhe.bounds["upper", "_x", "dphi"] = 6
    mhe.set_nl_cons("p_est_lb", -mhe._p_est["Theta_1"] + 1e-5, 0)
    mhe.set_nl_cons("p_est_ub", mhe._p_est["Theta_1"] - 1e-3, 0)
    mhe.setup()
    return mhe


def seeded_ys(n_y, seed=7):
    return 0.1 * np.random.default_rng(seed).standard_normal((3, n_y, 1))


def run_loop(mhe, ys):
    """tests/test_mhe_structured_kkt.py:65-70, with the iterations."""
    mhe.x0 = np.zeros(mhe.model.n_x)
    mhe.p_est0 = 1e-4
    mhe.set_initial_guess()
    xs, iters = [], []
    for y in ys:
        xs.append(mhe.make_step(y).ravel())
        iters.append(mhe.solver_stats["iter_count"])
        assert mhe.solver_stats["success"]
    return np.concatenate(xs), iters, float(mhe._p_est0.data[0])


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.fixture(scope="module")
def runs(_cpu_port):
    """The JAX MHE (dense KKT) and the port's, dense and bordered-band,
    each run for three steps; the port's band sweeps counted, and the JAX
    MHE's state after its steps kept."""
    jm, tm = small_masses_model(jdm), small_masses_model(tdm)
    ys = seeded_ys(jm.n_y)
    jmhe = build_mhe(jdm, jm, "dense")
    out = {"jax": run_loop(jmhe, ys), "jmhe": jmhe,
           "jax_state": mhe_state_arrays(jmhe)}
    with pytest.MonkeyPatch.context() as mp:
        sweeps = _Counting(band_qr.band_solve)
        mp.setattr(band_qr, "band_solve", sweeps)
        for kkt in ("dense", "tridiag"):
            tmhe = build_mhe(tdm, tm, kkt)
            sweeps.calls = 0
            out[kkt] = dict(port=run_loop(tmhe, ys), tmhe=tmhe,
                            sweeps=sweeps.calls)
    return out


@pytest.mark.parametrize("kkt", ["dense", "tridiag"])
def test_make_step_matches_jax(runs, kkt):
    (x_j, it_j, p_j), (x_t, it_t, p_t) = runs["jax"], runs[kkt]["port"]
    assert it_t == it_j
    assert _rel(x_t, x_j) <= 1e-8
    assert abs(p_t - p_j) <= 1e-8 * max(1.0, abs(p_j))
    assert np.all(np.isfinite(x_t))


def test_bordered_band_matches_dense(runs):
    """tests/test_mhe_structured_kkt.py:73-92 on the port: the estimated
    parameter sits in the root border of one chain of N+1 stages, the
    chain sweep is band_qr's, and the two backends land on the same
    estimates."""
    dense, band = runs["dense"], runs["tridiag"]
    assert not hasattr(dense["tmhe"], "_kkt_structure")
    asm = band["tmhe"]._kkt_structure
    assert asm.R > 0 and asm.C == 1 and asm.S == N_TRIM + 1
    assert dense["sweeps"] == 0
    # float64: a refinement pass, so at least two sweeps per Newton step
    assert band["sweeps"] >= 2 * sum(band["port"][1])
    err = np.max(np.abs(dense["port"][0] - band["port"][0]))
    assert err < 1e-6, f"dense vs bordered-band estimate diff {err:.2e}"


def _oracle_point(mhe, seed=3):
    """A seeded point: decision vector, parameter vector and multipliers,
    with the estimated parameter near its nominal value."""
    rng = np.random.default_rng(seed)
    w = 0.1 * rng.standard_normal(mhe.n_opt_x)
    w[mhe.layout.sl(("p_est",))] = 2.25e-4 * (1.0 + 0.1 * rng.random())
    p = 0.1 * rng.standard_normal(mhe.n_opt_p)
    p[mhe._p_sl["p_est_prev"]] = 2.0e-4
    lam_g = rng.standard_normal(mhe.n_opt_lagr)
    lam_h = rng.random(mhe._n_ineq)
    return w, p, lam_g, lam_h


def test_oracles_match_jax(runs):
    jmhe, tmhe = runs["jmhe"], runs["tridiag"]["tmhe"]
    assert (tmhe.n_opt_x, tmhe.n_opt_p, tmhe.n_opt_lagr, tmhe._n_ineq) == (
        jmhe.n_opt_x, jmhe.n_opt_p, jmhe.n_opt_lagr, jmhe._n_ineq)
    np.testing.assert_array_equal(tmhe._A_all, jmhe._A_all)
    np.testing.assert_array_equal(tmhe._lb_opt_x, jmhe._lb_opt_x)
    np.testing.assert_array_equal(tmhe._ub_opt_x, jmhe._ub_opt_x)
    w, p, lam_g, lam_h = _oracle_point(jmhe)
    T = tmhe._tensor
    for name in ("_f_fn", "_g_fn", "_h_fn", "_grad_f_fn", "_jac_g_fn",
                 "_jac_h_fn", "_hess_fn"):
        args = (w, p) + ((lam_g, lam_h) if name == "_hess_fn" else ())
        # jitted: JAX's eager Hessian takes ten times its compile time
        j = np.asarray(jax.jit(getattr(jmhe, name))(*args))
        t = getattr(tmhe, name)(*map(T, args))
        assert t.shape == j.shape, f"{name}: {t.shape} vs {j.shape}"
        assert _rel(t.numpy(), j) <= 1e-12, name
    # the batch axis: two points at once equal each alone
    W = np.stack([w, 0.5 * w])
    W[1, tmhe.layout.sl(("p_est",))] = w[tmhe.layout.sl(("p_est",))]
    P = np.stack([p, p])
    both = tmhe._hess_fn(T(W), T(P), T(np.stack([lam_g] * 2)),
                         T(np.stack([lam_h] * 2)))
    one = tmhe._hess_fn(T(W[1]), T(p), T(lam_g), T(lam_h))
    assert _rel(both[1].numpy(), one.numpy()) <= 1e-14


def test_continues_from_jax_state(runs):
    """interop.load_mhe_state: a port MHE started from the JAX MHE's state
    after its three steps takes the JAX MHE's fourth step."""
    jmhe = runs["jmhe"]
    tmhe = build_mhe(tdm, runs["dense"]["tmhe"].model, "dense")
    load_mhe_state(tmhe, runs["jax_state"])
    y4 = 0.1 * np.random.default_rng(8).standard_normal((jmhe.model.n_y, 1))
    x_j, x_t = jmhe.make_step(y4), tmhe.make_step(y4)
    assert tmhe.solver_stats["iter_count"] == \
        jmhe.solver_stats["iter_count"]
    assert _rel(x_t, x_j) <= 1e-8
    np.testing.assert_array_equal(tmhe.data._y, jmhe.data._y[-4:])


# ---- tests/test_mhe_p_est_bounds.py:81-116 and test_optx_view.py:89-104 --

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
