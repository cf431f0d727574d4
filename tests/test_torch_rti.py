"""The real-time-iteration (RTI) modes and ``tol_loop`` of the PyTorch
port's interior-point solver against the JAX package's (float64, CPU), on
oscillating masses (discrete, 39 variables: a cheap JAX compile).

The same inputs go through ``dompc_tpu.parallel.make_batch_solver`` and
the port's, and through both packages' ``MPC.make_step``:

* a cold call through an RTI solver runs the full globalized loop: the
  iterations equal JAX's and exceed ``rti_iters``; u0 within 1e-8;
* a warm RTI(2) call takes exactly 2 iterations: w, lam and u0 within 1e-8;
* bounded drift on that batch: each element stops correcting on its own;
* bounded-drift RTI and the filter-RTI hybrid over 6 closed-loop steps of
  the discrete plant: per step equal iterations and u0 within 1e-8, every
  step certifies, the hybrid within ``rti_iters + rti_extra_max``;
* (in ``tests/test_torch_rti_make_step.py``) ``make_step`` with
  ``solver_rti_iters=2`` and with ``solver_tol_loop``;
* (slow) the flagship's RTI closed loop against the converged one, the
  counterpart of ``tests/test_rti.py:93-151``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import dompc_tpu.systems as jsys  # noqa: E402
from dompc_tpu.parallel import (  # noqa: E402
    make_batch_solver as jax_make_batch_solver)
import dompc_tpu_torch.systems as tsys  # noqa: E402
from dompc_tpu_torch.interop import (load_mpc_state,  # noqa: E402
                                     mpc_state_arrays)
from dompc_tpu_torch.parallel import make_batch_solver  # noqa: E402

TOL = 1e-8
A = np.array([[0.763, 0.460, 0.115, 0.020],
              [-0.899, 0.763, 0.420, 0.115],
              [0.115, 0.020, 0.763, 0.460],
              [0.420, 0.115, -0.899, 0.763]])
BM = np.array([0.014, 0.063, 0.221, 0.367])
X0 = np.array([0.4, -0.2, 0.3, 0.1])


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        mp.delenv("DOMPC_TPU_BAND_BACKEND", raising=False)
        yield
    torch.set_num_threads(threads)


def _pair(**settings):
    """The JAX and the port MPC for oscillating masses, with ``settings``
    applied to both and the port started from the JAX MPC's state."""
    mj = jsys.oscillating_masses_mpc(jsys.oscillating_masses_model())
    mt = tsys.oscillating_masses_mpc(tsys.oscillating_masses_model())
    if settings:
        for mpc in (mj, mt):
            for key, val in settings.items():
                setattr(mpc.settings, key, val)
            mpc._create_solver()
    mj.x0 = X0
    mj.set_initial_guess()
    load_mpc_state(mt, mpc_state_arrays(mj))
    return mj, mt


@pytest.fixture(scope="module")
def mpcs(_cpu_port):
    return _pair()


def _close(a, b, tol=1e-8):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b))), \
        np.max(np.abs(a - b))


@pytest.fixture(scope="module")
def rti2(mpcs):
    """Cold then warm RTI(2) calls of a batch of 4 in both packages."""
    mj, mt = mpcs
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-0.4, 0.4, size=(4, 4))
    w0 = np.tile(mj.opt_x_num.copy(), (4, 1))
    kw = dict(tol=1e-6, max_iter=80, rti_iters=2)
    sj = jax_make_batch_solver(mj, **kw)
    st = make_batch_solver(mt, **kw)
    cold = (sj(jnp.asarray(x0s), jnp.asarray(w0)), st(x0s, w0))
    (cj, _), (ct, _) = cold
    mu0 = np.full(4, 1e-6)
    warm = (sj(jnp.asarray(x0s * 0.98), cj.w, cj.lam, jnp.asarray(mu0),
               cj.zl, cj.zu),
            st(x0s * 0.98, ct.w, ct.lam, mu0, ct.zl, ct.zu))
    # bounded drift from the same warm inputs: the elements need different
    # numbers of corrective steps, and each stops on its own
    kw = dict(tol=TOL, max_iter=80, rti_iters=1, rti_drift_tol=3e-7)
    drift = (jax_make_batch_solver(mj, **kw)(
        jnp.asarray(x0s * 0.98), cj.w, cj.lam, jnp.asarray(mu0), cj.zl,
        cj.zu), make_batch_solver(mt, **kw)(x0s * 0.98, ct.w, ct.lam, mu0,
                                            ct.zl, ct.zu))
    return cold, warm, drift


def test_cold_call_through_rti_solver_runs_full_loop(rti2):
    (sol_j, u_j), (sol_t, u_t) = rti2[0]
    np.testing.assert_array_equal(sol_t.iterations.numpy(),
                                  np.asarray(sol_j.iterations))
    assert int(sol_t.iterations.min()) > 2
    assert bool(sol_t.success.all())
    _close(u_t.numpy(), u_j)


def test_warm_rti_matches_jax(rti2):
    (sol_j, u_j), (sol_t, u_t) = rti2[1]
    assert sol_t.iterations.tolist() == [2] * 4
    np.testing.assert_array_equal(sol_t.iterations.numpy(),
                                  np.asarray(sol_j.iterations))
    _close(sol_t.w.numpy(), sol_j.w)
    _close(sol_t.lam.numpy(), sol_j.lam)
    _close(u_t.numpy(), u_j)
    np.testing.assert_array_equal(sol_t.success.numpy(),
                                  np.asarray(sol_j.success))


def test_drift_batch_elements_stop_on_their_own(rti2):
    (sol_j, u_j), (sol_t, u_t) = rti2[2]
    it = sol_t.iterations.tolist()
    assert it == np.asarray(sol_j.iterations).tolist()
    assert len(set(it)) > 1, it
    np.testing.assert_array_equal(sol_t.success.numpy(),
                                  np.asarray(sol_j.success))
    assert bool(sol_t.success.all())
    _close(sol_t.w.numpy(), sol_j.w)
    _close(u_t.numpy(), u_j)


def _closed_loop(mpcs, steps=6, **kw):
    """A cold call then ``steps`` warm calls along the discrete plant, both
    packages fed the same plant state (the JAX loop's)."""
    mj, mt = mpcs
    w0 = mj.opt_x_num.copy()[None, :]
    sj = jax_make_batch_solver(mj, **kw)
    st = make_batch_solver(mt, **kw)
    x = X0.copy()
    sol_j, u_j = sj(jnp.asarray(x[None]), jnp.asarray(w0))
    sol_t, u_t = st(x[None], w0)
    rows = []
    for _ in range(steps):
        x = A @ x + BM * float(u_j[0, 0])
        mu0 = np.full(1, 1e-6)
        sol_j, u_j = sj(jnp.asarray(x[None]), sol_j.w, sol_j.lam,
                        jnp.asarray(mu0), sol_j.zl, sol_j.zu)
        sol_t, u_t = st(x[None], sol_t.w, sol_t.lam, mu0, sol_t.zl,
                        sol_t.zu)
        rows.append((sol_j, u_j, sol_t, u_t))
    return rows


@pytest.mark.parametrize("mode", ["drift", "filter"])
def test_rti_closed_loop_modes_match_jax(mpcs, mode):
    """Bounded-drift RTI(1) and the filter-RTI hybrid RTI(2), 6 steps."""
    drift_tol, n_rti, n_extra = 1e-5, {"drift": 1, "filter": 2}[mode], 6
    kw = dict(tol=TOL, max_iter=80, rti_iters=n_rti, rti_drift_tol=drift_tol,
              rti_extra_max=n_extra, rti_filter=mode == "filter")
    for sol_j, u_j, sol_t, u_t in _closed_loop(mpcs, **kw):
        assert int(sol_t.iterations[0]) == int(sol_j.iterations[0])
        assert int(sol_t.iterations[0]) <= n_rti + n_extra
        assert bool(sol_t.success[0]) and bool(sol_j.success[0])
        assert float(sol_t.kkt_err[0]) <= drift_tol
        _close(u_t.numpy(), u_j)


def _make_steps(mj, mt, n=2):
    x = X0.copy()
    for k in range(n):
        u_j = mj.make_step(x)
        u_t = mt.make_step(x)
        for key in ("iter_count", "success"):
            assert mt.solver_stats[key] == mj.solver_stats[key], (k, key)
        _close(u_t, u_j)
        _close(mt.opt_x_num, mj.opt_x_num)
        x = A @ x + BM * float(u_j[0, 0])
    return mj, mt


@pytest.mark.slow
def test_rti_nonlinear_cstr_closed_loop(_cpu_port):
    """The port's counterpart of tests/test_rti.py:93-151 on the CPU: the
    flagship (N=20) against ``Simulator`` for 8 steps, fully converged and
    in RTI(3) through ``make_shift_fn``; F within 6e-2, states within
    2e-2, tracking-cost ratio in [0.7, 1.3], every full step certified,
    every warm RTI step exactly 3 iterations.  ``chip_smoke.py`` phase 8
    runs the same loops on the card."""
    import chip_smoke
    res = chip_smoke.closed_loop_pair()
    assert not chip_smoke.closed_loop_faults(res)
