"""The NLP differentiator of the PyTorch port against the JAX package's
(float64, CPU).

The flows of ``tests/test_satellites.py:50-173`` on the oscillating masses
(N=7): the free problem, and the problem with an active ``nl_cons`` u <= 0.3
that pins the first input.  The JAX MPC solves once; the port MPC is loaded
with that solution (``interop.load_mpc_state``), so both packages
differentiate at the same point.  Sensitivities within 1e-10 relative, the
active sets and the status flags equal.  A third problem makes the KKT matrix
exactly singular (the nl_cons duplicates the active input bound), so both
packages take the least-squares path: numpy's ``lstsq`` (minimum norm) in
JAX, the pseudo-inverse in the port.  ``-m slow`` adds the flagship robust
CSTR at N=4.
"""
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems  # noqa: F401
import dompc_tpu_torch as tdm
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


TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(1.0, np.max(np.abs(b), initial=0.0)))


def _masses(dm, case):
    """The oscillating masses' MPC (tests/test_satellites.py:124-140) of
    either package: ``free`` without nl_cons, ``active`` with u <= 0.3,
    ``singular`` with u <= 0.3 on top of an input bound at 0.3."""
    model = dm.systems.oscillating_masses_model()
    if case == "free":
        return dm.systems.oscillating_masses_mpc(model)
    mpc = dm.controller.MPC(model)
    mpc.settings.n_horizon = 7
    mpc.settings.t_step = 0.5
    mpc.set_objective(mterm=model.aux["cost"], lterm=model.aux["cost"])
    mpc.set_rterm(u=1e-4)
    max_x = np.array([[4.0], [10.0], [4.0], [10.0]])
    mpc.bounds["lower", "_x", "x"] = -max_x
    mpc.bounds["upper", "_x", "x"] = max_x
    mpc.bounds["lower", "_u", "u"] = -0.5
    mpc.bounds["upper", "_u", "u"] = 0.3 if case == "singular" else 0.5
    mpc.set_nl_cons("ulim", model.u["u"], ub=0.3)
    mpc.setup()
    return mpc


@pytest.fixture(scope="module", params=["free", "active", "singular"])
def solved(request):
    """(case, JAX MPC, port MPC) at the JAX MPC's solution from the seed-99
    state of tests/test_satellites.py."""
    case = request.param
    jm, tm = _masses(jdm, case), _masses(tdm, case)
    np.random.seed(99)
    x0 = np.random.rand(4) - 0.5
    jm.x0 = x0
    jm.set_initial_guess()
    jm.make_step(x0)
    load_mpc_state(tm, mpc_state_arrays(jm))
    return case, jm, tm


def _differentiate(dm, mpc):
    diff = dm.differentiator.DoMPCDifferentiator(mpc)
    diff.settings.check_LICQ = True
    diff.settings.check_SC = True
    diff.settings.check_rank = True
    dx_dp, dlam_dp = diff.differentiate()
    return diff, dx_dp, dlam_dp


def test_sensitivities_match_jax(solved, monkeypatch):
    """dx/dp and dlam/dp within 1e-10, the active sets and the status
    flags equal; the singular case goes through the least-squares path in
    both packages."""
    case, jm, tm = solved
    calls = {"lstsq": 0, "pinv": 0}
    lstsq, pinv = np.linalg.lstsq, torch.linalg.pinv

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(np.linalg, "lstsq", count("lstsq", lstsq))
    monkeypatch.setattr(torch.linalg, "pinv", count("pinv", pinv))
    jd, jx, jl = _differentiate(jdm, jm)
    td, tx, tl = _differentiate(tdm, tm)
    assert _rel(tx, jx) <= TOL
    assert _rel(tl, jl) <= TOL
    n = jm.n_opt_x
    zl, zu = jm._zl_warm[:n], jm._zu_warm[:n]
    for ja, ta in zip(jd._active_sets(jm.opt_x_num, jm.lam_g_num, zl, zu),
                      td._active_sets(tm.opt_x_num, tm.lam_g_num, zl, zu)):
        np.testing.assert_array_equal(ta, ja)
    for field in ("LICQ", "SC", "lse_solved", "full_rank", "sym_KKT_system",
                  "reduced_nlp"):
        assert getattr(td.status, field) == getattr(jd.status, field), field
    assert jd.status.residuals < 1e-12 and td.status.residuals < 1e-12
    want = 1 if case == "singular" else 0
    assert calls == {"lstsq": want, "pinv": want}
    u_sl, x0_sl = jm.layout.sl(("u", 0, 0)), jm._p_sl["x0"]
    np.testing.assert_array_equal(td.du0_dx0(), tx[u_sl, x0_sl])
    if case == "free":
        assert td.status.LICQ and td.status.full_rank
    elif case == "active":
        # tests/test_satellites.py:159-173: the pinned input does not move
        assert td.status.LICQ
        assert abs(float(tm.opt_x_num[u_sl][0]) - 0.3) < 1e-5
        np.testing.assert_allclose(tx[u_sl, x0_sl], 0.0, atol=1e-6)
    else:
        assert not td.status.LICQ and not td.status.full_rank
        # without the fallback both packages raise numpy's LinAlgError
        for dm, mpc in ((jdm, jm), (tdm, tm)):
            diff = dm.differentiator.DoMPCDifferentiator(mpc)
            diff.settings.lstsq_fallback = False
            with pytest.raises(np.linalg.LinAlgError):
                diff.differentiate()


@pytest.mark.slow
def test_flagship_du0_dx0_matches_jax():
    """The flagship robust CSTR at N=4: du0/dx0 after one step, the port
    loaded with the JAX solution."""
    import __graft_entry__ as ge
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    jm = ge._build_cstr_mpc(n_horizon=4)
    tm = cstr_robust_mpc(n_horizon=4)
    jm.x0 = CSTR_X0
    jm.set_initial_guess()
    jm.make_step(CSTR_X0)
    load_mpc_state(tm, mpc_state_arrays(jm))
    jd = jdm.differentiator.DoMPCDifferentiator(jm)
    td = tdm.differentiator.DoMPCDifferentiator(tm)
    assert _rel(td.du0_dx0(), jd.du0_dx0()) <= TOL
    assert _rel(td.dx_dp_num, jd.dx_dp_num) <= TOL
