"""The kite, the kinematic and dynamic bicycles and the industrial
polymerization reactor of the PyTorch port against the JAX package
(float64, CPU).

Each system is built by each package's copy of the same construction code
(``systems/_kite.py``, ``_bicycle.py``, ``_industrial_poly.py``), at N=3:

* the model's right-hand side and its Jacobians at a seeded point;
* the MPC's NLP oracles f, g, h, grad_f, jac_g, jac_h and the Lagrangian
  Hessian at a seeded (w, lambda);

all within 1e-12 relative.  The kinematic bicycle's ``make_step`` at N=5
from the same state agrees to 1e-8 at equal iterations (the reference
suite's end-to-end tolerance, BASELINE.md:15).  Full-width ``make_step``
parity of the kite (N=40) and the polymerization (N=20, 9 scenarios) is
marked ``slow``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dompc_tpu.systems as jsys
import dompc_tpu_torch.systems as tsys
from dompc_tpu_torch.interop import mpc_state_arrays, load_mpc_state


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


TOL = 1e-12

# (model function, MPC function, x0 of the JAX package's tests, nominal
# parameters)
SYSTEMS = {
    "kite": ("kite_model", "kite_mpc", np.array([0.5, 0.3, 0.0]),
             np.array([5.0, 8.0])),
    "kinematic_bicycle": ("kinematic_bicycle_model",
                          "kinematic_bicycle_mpc",
                          np.array([0.0, 0.0, 0.0, 0.1]), np.zeros(0)),
    "dynamic_bicycle": ("dynamic_bicycle_model", "dynamic_bicycle_mpc",
                        np.array([0.0, 0.0, 0.0, 0.1, 0.0, 0.0]),
                        np.zeros(0)),
    "industrial_poly": ("industrial_poly_model", "industrial_poly_mpc",
                        None, np.array([950.0, 7.0])),
}


def _x0(name):
    x0 = SYSTEMS[name][2]
    return jsys.industrial_poly_x0() if x0 is None else x0


def _build(pkg, name, n_horizon):
    model_fn, mpc_fn = SYSTEMS[name][:2]
    model = getattr(pkg, model_fn)()
    return getattr(pkg, mpc_fn)(model, n_horizon=n_horizon)


@pytest.fixture(scope="module")
def pairs(_cpu_port):
    out = {}
    for name in SYSTEMS:
        mj, mt = _build(jsys, name, 3), _build(tsys, name, 3)
        mj.x0 = _x0(name)
        mj.set_initial_guess()
        load_mpc_state(mt, mpc_state_arrays(mj))
        out[name] = (mj, mt)
    return out


def _rel(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref), initial=0.0)
                 / max(float(np.abs(ref).max(initial=0.0)), 1.0))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_model_rhs_and_jacobians_match(pairs, name):
    mj, mt = pairs[name]
    m_j, m_t = mj.model, mt.model
    rng = np.random.default_rng(3)
    x = _x0(name) * (1 + 0.05 * rng.standard_normal(m_j.n_x)) \
        + 0.01 * rng.standard_normal(m_j.n_x)
    u = (mj._u_lb.data + mj._u_ub.data) / 2 \
        + 0.1 * rng.standard_normal(m_j.n_u)
    p = SYSTEMS[name][3] * (1 + 0.1 * rng.standard_normal(m_j.n_p))
    args = (x, u, np.zeros(0), np.zeros(m_j.n_tvp), p, np.zeros(m_j.n_w))
    for fn in ("_rhs_fun", "_A_fun", "_B_fun"):
        ref = np.asarray(getattr(m_j, fn)(*[jnp.asarray(v) for v in args]))
        got = getattr(m_t, fn)(*[torch.as_tensor(v) for v in args]).numpy()
        assert _rel(got, ref) <= TOL, (name, fn)


_ORACLES = {"f": ("_f_fn", 2), "g": ("_g_fn", 2), "h": ("_h_fn", 2),
            "grad_f": ("_grad_f_fn", 2), "jac_g": ("_jac_g_fn", 2),
            "jac_h": ("_jac_h_fn", 2), "hess": ("_hess_fn", 4)}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_nlp_oracles_match(pairs, name):
    mj, mt = pairs[name]
    assert mt.layout.offsets == mj.layout.offsets
    rng = np.random.default_rng(5)
    w = np.asarray(mj.opt_x_num) * (1 + 0.02 * rng.standard_normal(
        mj.n_opt_x)) + 0.01 * rng.standard_normal(mj.n_opt_x)
    pvec = mj._assemble_opt_p(_x0(name))
    point = (w, pvec, rng.standard_normal(mj.n_opt_lagr),
             rng.standard_normal(mj._n_ineq))
    for key, (attr, n_args) in sorted(_ORACLES.items()):
        if key == "jac_h" and not mj._n_ineq:
            continue
        args = point[:n_args]
        ref = np.asarray(jax.jit(getattr(mj, attr))(
            *[jnp.asarray(a) for a in args]))
        got = getattr(mt, attr)(*[torch.as_tensor(a) for a in args]).numpy()
        assert _rel(got, ref) <= TOL, (name, key, _rel(got, ref))


def _step_parity(name, n_horizon):
    mj, mt = _build(jsys, name, n_horizon), _build(tsys, name, n_horizon)
    x0 = _x0(name)
    mj.x0 = x0
    mj.set_initial_guess()
    load_mpc_state(mt, mpc_state_arrays(mj))
    u_j = mj.make_step(x0)
    u_t = mt.make_step(x0)
    # the polymerization's cold step ends at max_iter in both packages
    # (kkt_err ~3.4e-6 against tol 1e-8), so certification is compared
    assert mt.solver_stats["success"] == mj.solver_stats["success"]
    assert mt.solver_stats["iter_count"] == mj.solver_stats["iter_count"]
    scale = np.maximum(1.0, np.abs(u_j))
    assert float(np.max(np.abs(u_t - u_j) / scale)) < 1e-8, (u_t, u_j)
    assert _rel(mt.opt_x_num, np.asarray(mj.opt_x_num)) < 1e-8


def test_kinematic_bicycle_make_step_matches_jax():
    _step_parity("kinematic_bicycle", 5)


@pytest.mark.slow
@pytest.mark.parametrize("name,n_horizon", [("kite", 40),
                                            ("industrial_poly", 20)])
def test_full_width_make_step_matches_jax(name, n_horizon):
    _step_parity(name, n_horizon)
