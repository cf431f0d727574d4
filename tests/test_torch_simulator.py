"""The closed loop of the PyTorch port against the JAX package (float64,
CPU): ``ops/integrators.py``, ``Simulator`` and ``make_step`` + ``Simulator``.

* every function of ``ops/integrators.py`` against JAX's on the CSTR
  right-hand side and on a small index-1 DAE, within 1e-12; the adaptive
  integrator's float32 tolerance floor (the port alone, against the
  analytic solution, as ``tests/test_model_simulator.py:71``);
* ``Simulator.make_step``: ``cstr_simulator`` for 3 steps within 1e-10
  with the same ``Data`` logs, oscillating masses (discrete) for 5 steps
  within 1e-12, and a continuous DAE model with ``init_algebraic_variables``;
* constants cached by ``sym`` and ``optimizer.const_cache`` may be made
  first inside a ``torch.func`` transform (the Radau stage Jacobian and the
  EKF covariance do this): later plain calls neither fail nor differ.

The flagship's closed loop (``make_step`` + ``Simulator``) is in
``tests/test_torch_closed_loop.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import dompc_tpu as jdm  # noqa: E402
import dompc_tpu.systems as jsys  # noqa: E402
from dompc_tpu.ops import integrators as jint  # noqa: E402
import dompc_tpu_torch as tdm  # noqa: E402
import dompc_tpu_torch.systems as tsys  # noqa: E402
from dompc_tpu_torch.ops import integrators as tint  # noqa: E402
from dompc_tpu_torch.optimizer import const_cache  # noqa: E402

X_CSTR = np.array([0.8, 0.5, 134.14, 130.0])
U_CSTR = np.array([18.0, -4500.0])
P_CSTR = np.array([1.0, 1.0])


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


@pytest.fixture(scope="module")
def problems():
    """(JAX, port) pairs of f(x, z, args) and g(x, z, args): the CSTR
    right-hand side (args = (u, p)) and an index-1 DAE (args = a)."""
    mj, mt = jsys.cstr_model(), tsys.cstr_model()

    def cstr_j(x, z, a):
        return mj._rhs_fun(x, a[0], z, jnp.zeros(0), a[1], jnp.zeros(0))

    def cstr_t(x, z, a):
        return mt._rhs_fun(x, a[0], z, x.new_zeros(0), a[1], x.new_zeros(0))

    def dae(stack):
        def f(x, z, a):
            return stack([-x[0] + z[0], -0.5 * x[1] + z[0] * x[0]])

        def g(x, z, a):
            return stack([z[0] - x[0] ** 2 - 0.1 * x[1] - a])
        return f, g

    return {"cstr": ((cstr_j, None), (cstr_t, None)),
            "dae": (dae(jnp.stack), dae(torch.stack))}


def _args(case, torch_side):
    if case == "dae":
        return 0.3
    conv = torch.as_tensor if torch_side else jnp.asarray
    return (conv(U_CSTR), conv(P_CSTR))


def _x0(case, torch_side):
    x = X_CSTR if case == "cstr" else np.array([0.7, -0.4])
    z = np.zeros(0) if case == "cstr" else np.array([0.4])
    conv = torch.as_tensor if torch_side else jnp.asarray
    return conv(x), conv(z)


# (name, case, call(integrators, f, g, x, z, args) -> array or tuple)
INTEGRATOR_CASES = [
    ("rk4_step", "cstr", lambda I, f, g, x, z, a: I.rk4_step(
        lambda xx, aa: f(xx, z, aa), x, a, 0.005 / 4)),
    ("ode_rk4", "cstr", lambda I, f, g, x, z, a: I.make_ode_integrator(
        lambda xx, aa: f(xx, z, aa), method="rk4", substeps=10)(x, a, 0.005)),
    ("ode_radau", "cstr", lambda I, f, g, x, z, a: I.make_ode_integrator(
        lambda xx, aa: f(xx, z, aa), substeps=2)(x, a, 0.005)),
    ("radau_stage", "dae", lambda I, f, g, x, z, a:
        I.make_radau_stage_solver(f, g, 1)(x, z, a, 0.2)),
    ("dae_fixed", "dae", lambda I, f, g, x, z, a:
        I.make_dae_integrator(f, g, 1, substeps=3)(x, z, a, 0.5)),
    ("adaptive_cstr", "cstr", lambda I, f, g, x, z, a:
        I.make_adaptive_dae_integrator(
            f, lambda xx, zz, aa: xx[:0], 0, init_substeps=6)(x, z, a, 0.005)),
    ("adaptive_dae", "dae", lambda I, f, g, x, z, a:
        I.make_adaptive_dae_integrator(f, g, 1, abstol=1e-8, reltol=1e-8)(
            x, z, a, 1.0)),
    ("newton_rootfind", "dae", lambda I, f, g, x, z, a:
        I.newton_rootfind(lambda zz, aa: g(x, zz, aa), z, a)),
]


@pytest.mark.parametrize("name,case,call", INTEGRATOR_CASES,
                         ids=[c[0] for c in INTEGRATOR_CASES])
def test_integrator_matches_jax(problems, name, case, call):
    (fj, gj), (ft, gt) = problems[case]
    ref = call(jint, fj, gj, *_x0(case, False), _args(case, False))
    got = call(tint, ft, gt, *_x0(case, True), _args(case, True))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, t in zip(ref, got):
        assert t.dtype == torch.float64 and t.shape == r.shape
        assert _rel(t.numpy(), r) <= 1e-12, (name, _rel(t.numpy(), r))


def test_adaptive_integrator_float32_tolerance_floor():
    """Tolerances below float32 resolution are clamped to ~50 eps: the
    trajectory stays accurate (the JAX package's regression test)."""
    def f(x, z, args):
        return torch.stack([-50.0 * x[0], x[0] - 0.5 * x[1]])

    step = tint.make_adaptive_dae_integrator(
        f, lambda x, z, a: x.new_zeros(0), n_z=0, abstol=1e-10,
        reltol=1e-10)
    exact0 = np.exp(-50.0 * 0.5)
    exact1 = (np.exp(-0.5 * 0.5) - np.exp(-50.0 * 0.5)) / 49.5
    for dtype, tol in ((torch.float64, 1e-8), (torch.float32, 2e-4)):
        xf, _ = step(torch.tensor([1.0, 0.0], dtype=dtype),
                     torch.zeros(0, dtype=dtype), None, 0.5)
        assert xf.dtype == dtype and bool(torch.isfinite(xf).all())
        assert abs(float(xf[0]) - exact0) < tol, (dtype, float(xf[0]))
        assert abs(float(xf[1]) - exact1) < tol, (dtype, float(xf[1]))
        assert step.last_steps < 200, (dtype, step.last_steps)


DATA_FIELDS = ("_x", "_u", "_z", "_y", "_aux", "_time", "_tvp", "_p")


def _same_logs(sim_t, sim_j, tol):
    for field in DATA_FIELDS:
        a, b = getattr(sim_t.data, field), getattr(sim_j.data, field)
        assert a.shape == b.shape, field
        if a.size:
            assert _rel(a, b) <= tol, (field, _rel(a, b))


def test_cstr_simulator_matches_jax():
    sims = [pkg.cstr_simulator(pkg.cstr_model()) for pkg in (jsys, tsys)]
    for sim in sims:
        sim.x0 = X_CSTR
        for k in range(3):
            sim.make_step((U_CSTR + [2.0 * k, 100.0 * k]).reshape(-1, 1))
    _same_logs(sims[1], sims[0], 1e-10)
    assert sims[1].adaptive_steps >= 1


def test_oscillating_masses_simulator_matches_jax():
    out = []
    for dm, pkg in ((jdm, jsys), (tdm, tsys)):
        sim = dm.Simulator(pkg.oscillating_masses_model())
        sim.set_param(t_step=0.5)
        sim.setup()
        sim.x0 = np.array([1.0, -0.5, 0.3, 0.2])
        for k in range(5):
            sim.make_step(np.array([[0.1 * (-1) ** k]]))
        out.append(sim)
    assert out[1].adaptive_steps is None
    _same_logs(out[1], out[0], 1e-12)


def _dae_model(dm):
    """x' = -x + z, 0 = z - x^2 - u: one state, one algebraic variable."""
    m = dm.model.Model("continuous")
    x = m.set_variable("_x", "x")
    z = m.set_variable("_z", "z")
    u = m.set_variable("_u", "u")
    m.set_rhs("x", -x + z)
    m.set_alg("z_def", z - x ** 2 - u)
    m.set_expression("xz", x * z)
    m.setup()
    return m


def test_dae_simulator_matches_jax():
    out = []
    for dm in (jdm, tdm):
        sim = dm.Simulator(_dae_model(dm))
        sim.set_param(t_step=0.1)
        sim.setup()
        sim.x0 = np.array([0.5])
        sim.z0 = np.array([0.0])
        sim.u0 = np.array([0.2])
        z0 = sim.init_algebraic_variables()
        np.testing.assert_allclose(z0.ravel(), [0.45], atol=1e-12)
        for k in range(3):
            sim.make_step(np.array([[0.2 + 0.1 * k]]))
        out.append(sim)
    _same_logs(out[1], out[0], 1e-12)


def test_constants_made_first_inside_a_transform():
    """A fresh model's array constant (oscillating masses' A and B) and a
    ``const_cache`` entry evaluated first under ``jacfwd`` / ``hessian``,
    then plainly and under other transforms: no functorch level error, and
    the same values as a model evaluated plainly first."""
    x = torch.tensor([0.3, -0.2, 0.1, 0.4], dtype=torch.float64)
    u = torch.tensor([0.2], dtype=torch.float64)
    e = torch.zeros(0, dtype=torch.float64)

    def rhs(model):
        return lambda xx: model._rhs_fun(xx, u, e, e, e, e)

    fresh, plain = tsys.oscillating_masses_model(), \
        tsys.oscillating_masses_model()
    ref = rhs(plain)(x)
    jac = torch.func.jacfwd(rhs(fresh))(x)           # first evaluation
    assert torch.equal(rhs(fresh)(x), ref)
    assert torch.equal(torch.func.jacfwd(rhs(fresh))(x), jac)
    assert torch.equal(jac, torch.func.jacrev(rhs(plain))(x))
    assert torch.equal(torch.func.vmap(rhs(fresh))(x[None])[0], ref)

    get = const_cache(np.array([1.0, 2.0]))

    def fn(v):
        return (get(v) * v).sum() * v.sum()
    v = torch.tensor([1.0, 2.0], dtype=torch.float64)
    hess = torch.func.hessian(fn)(v)                  # first evaluation
    assert torch.equal(hess, torch.tensor([[2.0, 3.0], [3.0, 4.0]],
                                          dtype=torch.float64))
    assert float(fn(v)) == 15.0
    assert torch.equal(torch.func.jacfwd(fn)(v),
                       torch.tensor([8.0, 11.0], dtype=torch.float64))
