"""Batched serving of the PyTorch port (``dompc_tpu_torch.parallel``)
against itself and against the JAX package (float64, CPU).

The robust CSTR at N=5 (the flagship's widths, horizon cut for time), with
bench.py's state noise:

* ``initial_guess_from_x0`` and ``make_shift_fn`` equal JAX's exactly;
* a batch of 3, cold then warm, equals three batches of one: u0 within
  1e-8 relative (BASELINE.md:15) at equal iterations, the counterpart of
  ``tests/test_parallel.py:17-36``;
* ``chunk=`` gives the unchunked result bit for bit
  (``tests/test_parallel.py:39-61``);
* the port's ``make_batch_solver`` against JAX's at B=2 in
  ``throughput_mode``: u0 within 1e-8 relative at equal iterations
  (without it: ``tests/test_torch_batch_full.py``);
* the ``DOMPC_TPU_BAND_BACKEND`` routing of the batched path, with
  counting wrappers around the two sweeps (on the CPU both run the plain
  version), the float64 warning, and the ``ValueError`` for the XLA-only
  names on a CUDA device (decided without one).
"""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from __graft_entry__ import _build_cstr_mpc  # noqa: E402
from dompc_tpu.parallel import (  # noqa: E402
    initial_guess_from_x0 as jax_initial_guess,
    make_batch_solver as jax_make_batch_solver,
    make_shift_fn as jax_make_shift_fn)
from dompc_tpu_torch.interop import (mpc_state_arrays,  # noqa: E402
                                     load_mpc_state)
from dompc_tpu_torch.parallel import (initial_guess_from_x0,  # noqa: E402
                                      make_batch_solver, make_shift_fn)
from dompc_tpu_torch.solver import band_qr, bbd  # noqa: E402
from dompc_tpu_torch.systems import (bench_states,  # noqa: E402
                                     cstr_robust_mpc, CSTR_X0)

N_HORIZON = 5


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    # one intra-op thread: the ops are small, and test workers running side
    # by side would otherwise each spin a pool over all the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        mp.delenv("DOMPC_TPU_BAND_BACKEND", raising=False)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mpcs(_cpu_port):
    mj = _build_cstr_mpc(n_horizon=N_HORIZON)
    mj.x0 = CSTR_X0
    mj.set_initial_guess()
    mt = cstr_robust_mpc(n_horizon=N_HORIZON)
    load_mpc_state(mt, mpc_state_arrays(mj))
    return mj, mt


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def _cold_warm(solve, x0s, W):
    """A cold call, then a warm one from its solution with x0 moved by
    1e-3 and mu0 = 1e-4 (bench.py:82-90)."""
    sol, u0 = solve(x0s, W)
    sol_w, u0_w = solve(x0s * (1.0 + 1e-3), sol.w, sol.lam, 1e-4, sol.zl,
                        sol.zu)
    return (sol, u0), (sol_w, u0_w)


@pytest.fixture(scope="module")
def batch3(mpcs):
    _, mt = mpcs
    x0s = bench_states(3)
    W = initial_guess_from_x0(mt, x0s)
    solve = make_batch_solver(mt, tol=1e-8, max_iter=60,
                              throughput_mode=True)
    return solve, x0s, W, _cold_warm(solve, x0s, W)


def test_initial_guess_and_shift_match_jax(mpcs):
    mj, mt = mpcs
    x0s = bench_states(4, seed=1)
    np.testing.assert_array_equal(initial_guess_from_x0(mt, x0s),
                                  np.asarray(jax_initial_guess(mj, x0s)))
    rng = np.random.default_rng(2)
    n_z = mt.n_opt_x + mt._n_ineq
    arrays = dict(w=rng.standard_normal((2, mt.n_opt_x)),
                  lam=rng.standard_normal((2, mt.n_opt_lagr + mt._n_ineq)),
                  zl=rng.standard_normal((2, n_z)),
                  zu=rng.standard_normal((2, n_z)))

    class Sol:
        def __init__(self, conv):
            for k, v in arrays.items():
                setattr(self, k, conv(v))

    got = make_shift_fn(mt)(Sol(torch.as_tensor))
    ref = jax_make_shift_fn(mj)(Sol(jnp.asarray))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_batch_equals_per_instance(batch3):
    solve, x0s, W, ((sol, u0), (sol_w, u0_w)) = batch3
    assert bool(sol.success.all()) and bool(sol_w.success.all())
    for i in range(3):
        (s1, u1), (s1_w, u1_w) = _cold_warm(solve, x0s[i:i + 1],
                                            W[i:i + 1])
        assert int(s1.iterations[0]) == int(sol.iterations[i])
        assert int(s1_w.iterations[0]) == int(sol_w.iterations[i])
        assert _rel(u1[0], u0[i]) <= 1e-8
        assert _rel(u1_w[0], u0_w[i]) <= 1e-8


def test_chunked_equals_unchunked(mpcs):
    _, mt = mpcs
    x0s = bench_states(4, seed=3)
    W = initial_guess_from_x0(mt, x0s)
    full = make_batch_solver(mt, tol=1e-8, max_iter=60,
                             throughput_mode=True)
    tiled = make_batch_solver(mt, tol=1e-8, max_iter=60,
                              throughput_mode=True, chunk=2)
    for (sol_f, u_f), (sol_c, u_c) in zip(_cold_warm(full, x0s, W),
                                          _cold_warm(tiled, x0s, W)):
        assert torch.equal(u_f, u_c)
        assert torch.equal(sol_f.iterations, sol_c.iterations)
        assert bool(sol_c.success.all())


def _against_jax(mpcs, **kw):
    """The port's and JAX's batch solvers, B=2, cold then warm: the same
    iterations, u0 within 1e-8 relative."""
    mj, mt = mpcs
    x0s = bench_states(2, seed=4)
    W = initial_guess_from_x0(mt, x0s)
    kw = dict(tol=1e-8, max_iter=60, **kw)
    port = _cold_warm(make_batch_solver(mt, **kw), x0s, W)
    jsolve = jax_make_batch_solver(mj, **kw)
    sol, u0 = jsolve(jnp.asarray(x0s), jnp.asarray(W))
    # the warm inputs as fresh arrays, like the cold call's own: its
    # compiled program then serves the warm call too (no second trace)
    sol_w, u0_w = jsolve(*(jnp.asarray(np.asarray(a)) for a in (
        x0s * (1.0 + 1e-3), sol.w, sol.lam, np.full(2, 1e-4), sol.zl,
        sol.zu)))
    for (s_t, u_t), (s_j, u_j) in zip(port, ((sol, u0), (sol_w, u0_w))):
        assert bool(s_t.success.all()) and bool(jnp.all(s_j.success))
        np.testing.assert_array_equal(s_t.iterations.numpy(),
                                      np.asarray(s_j.iterations))
        assert _rel(u_t.numpy(), u_j) <= 1e-8


def test_batch_solver_matches_jax_throughput_mode(mpcs):
    """Without throughput mode: tests/test_torch_batch_full.py."""
    _against_jax(mpcs, throughput_mode=True)


class _Counting:
    """Wraps a sweep and counts its calls (on the CPU the kernels'
    counters stay at 0: the plain version runs)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.fixture
def sweeps(monkeypatch):
    qr = _Counting(band_qr.band_solve)
    tiled = _Counting(band_qr.band_solve_tiled)
    monkeypatch.setattr(band_qr, "band_solve", qr)
    monkeypatch.setattr(band_qr, "band_solve_tiled", tiled)
    return qr, tiled


@pytest.fixture(scope="module")
def mpc32(_cpu_port):
    """The port's float32 MPC (the card's production precision)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_X64", "0")
        mt = cstr_robust_mpc(n_horizon=N_HORIZON)
    assert mt._dtype == torch.float32
    return mt


@pytest.mark.parametrize("choice,x64,sweep,per_step", [
    ("", False, "qr", 1), ("pallas_tiled", False, "tiled", 1),
    ("pallas", True, "qr", 2), ("pallas_tiled", True, "qr", 2)])
def test_band_backend_routing(mpcs, mpc32, sweeps, monkeypatch, choice,
                              x64, sweep, per_step):
    """The backend is read once, when the KKT backend is built.  In
    float32 (no refinement) a batch sweeps once per Newton step, in
    float64 twice (throughput mode's one refinement pass); pallas_tiled in
    float64 warns and takes the band-QR sweep, as JAX falls back."""
    mt = mpcs[1] if x64 else mpc32
    monkeypatch.setenv("DOMPC_TPU_BAND_BACKEND", choice)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solve = make_batch_solver(mt, tol=1e-8, max_iter=2,
                                  throughput_mode=True)
    assert any("requires float32" in str(w.message) for w in caught) == \
        (x64 and choice == "pallas_tiled")
    monkeypatch.setenv("DOMPC_TPU_BAND_BACKEND", "")   # read at build only
    x0s = bench_states(2, seed=5)
    solve(x0s, initial_guess_from_x0(mt, x0s))
    qr, tiled = sweeps
    steps = solve.ipm.newton_steps
    assert steps == 2
    calls = {"qr": qr.calls, "tiled": tiled.calls}
    assert calls.pop(sweep) == per_step * steps
    assert list(calls.values()) == [0]


@pytest.mark.parametrize("choice", ["lanes", "lanes_wy", "scan", "bogus"])
def test_band_backend_xla_names_raise_on_cuda(monkeypatch, choice):
    monkeypatch.setenv("DOMPC_TPU_BAND_BACKEND", choice)
    with pytest.raises(ValueError, match="pallas_tiled"):
        bbd.band_backend(torch.float32, "cuda")
    # on the CPU every choice runs the plain sweep
    assert bbd.band_backend(torch.float32, "cpu") == choice
