"""The double inverted pendulum (index-1 DAE, Radau collocation of degree 3,
state-only obstacle nl_cons) in the PyTorch port against the JAX package
(float64, CPU).

* ``make_step`` at N=8 with the condensed KKT, the flow of
  ``tests/test_dip_condensed.py:18-70`` (the JAX MPC is built by that
  test's own ``_mpc``, so its compiled program is the one that test
  caches): u0 within 1e-8 at equal iterations, from the same numeric state
  (``interop.load_mpc_state``);
* the port's probe: the nl_cons does not reference z, so the condensation
  plan stands;
* the port's ``tridiag`` backend against its own condensed answer, within
  that test's 1e-7;
* ``systems.dip_simulator`` (``"idas"``, the adaptive Radau DAE route):
  ``init_algebraic_variables`` and one plant step against JAX's, 1e-10.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_dip import dip_model as jax_dip_model  # noqa: E402
from test_dip_condensed import _mpc as jax_mpc  # noqa: E402
import dompc_tpu.systems as jsys  # noqa: E402
import dompc_tpu_torch as tdm  # noqa: E402
import dompc_tpu_torch.systems as tsys  # noqa: E402
from dompc_tpu_torch.interop import (load_mpc_state,  # noqa: E402
                                     mpc_state_arrays)


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


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def port_mpc(model, kkt, n_horizon=8):
    """``tests/test_dip_condensed.py:_mpc`` through the port's API."""
    mpc = tdm.controller.MPC(model)
    s = mpc.settings
    s.n_horizon = n_horizon
    s.n_robust = 0
    s.t_step = 0.04
    s.collocation_deg = 3
    s.collocation_ni = 1
    s.kkt_solver = kkt
    mterm = model.aux["E_kin"] - model.aux["E_pot"]
    lterm = -model.aux["E_pot"] \
        + 10 * (model.x["pos"] - model.tvp["pos_set"])**2
    mpc.set_objective(mterm=mterm, lterm=lterm)
    mpc.set_rterm(force=0.1)
    mpc.bounds["lower", "_u", "force"] = -4
    mpc.bounds["upper", "_u", "force"] = 4
    mpc.set_nl_cons("obstacles", -model.aux["obstacle_distance"], 0)
    p_template = mpc.get_p_template(1)
    p_template["_p", 0, "m1"] = 0.2
    p_template["_p", 0, "m2"] = 0.2
    mpc.set_p_fun(lambda t: p_template)
    tvp_template = mpc.get_tvp_template()

    def tvp_fun(t):
        for k in range(s.n_horizon + 1):
            tvp_template["_tvp", k, "pos_set"] = -0.8
        return tvp_template
    mpc.set_tvp_fun(tvp_fun)
    mpc.setup()
    return mpc


X0 = np.zeros(6)
X0[1:3] = 0.95 * np.pi


@pytest.fixture(scope="module")
def condensed_steps(_cpu_port):
    mj = jax_mpc(jax_dip_model(), "condensed")
    mj.x0 = X0
    mj.set_initial_guess()
    mt = port_mpc(tsys.dip_model(), "condensed")
    load_mpc_state(mt, mpc_state_arrays(mj))
    u_j = mj.make_step(X0)
    u_t = mt.make_step(X0)
    return mj, mt, u_j, u_t


def test_dip_condensed_make_step_matches_jax(condensed_steps):
    mj, mt, u_j, u_t = condensed_steps
    assert mt._nl_cons_z_independent()
    assert mt._condensation_plan() is not None, \
        "z-independent nl_cons must not disable condensation"
    assert mt.solver_stats["success"] and mj.solver_stats["success"]
    assert mt.solver_stats["iter_count"] == mj.solver_stats["iter_count"]
    assert np.all(np.isfinite(u_t))
    assert _rel(u_t, u_j) <= 1e-8
    assert _rel(mt.opt_x_num, np.asarray(mj.opt_x_num)) <= 1e-8


def test_dip_tridiag_matches_condensed(condensed_steps):
    _, mt, _, u_t = condensed_steps
    mb = port_mpc(mt.model, "tridiag")
    mb.x0 = X0
    mb.set_initial_guess()
    u_b = mb.make_step(X0)
    assert mb.solver_stats["success"]
    assert float(np.max(np.abs(u_b - u_t))) < 1e-7


def test_dip_simulator_step_matches_jax():
    sims = []
    for sysmod, model in ((jsys, jax_dip_model()), (tsys, tsys.dip_model())):
        sim = sysmod.dip_simulator(model)
        assert sim.settings.integration_tool in ("idas", "radau")
        sim.x0["theta"] = 0.9 * np.pi
        sim.x0["pos"] = 0
        sim.init_algebraic_variables()
        z0 = np.array(sim.z0.data if hasattr(sim.z0, "data") else sim.z0,
                      dtype=float).copy()
        y = sim.make_step(np.array([[1.5]]))
        sims.append((sim, z0, y))
    (sj, z_j, y_j), (st, z_t, y_t) = sims
    assert np.all(np.isfinite(z_t)) and np.max(np.abs(z_t)) > 0
    assert _rel(z_t, z_j) <= 1e-10
    assert _rel(y_t, y_j) <= 1e-10
    for attr in ("_x", "_z", "_u", "_time"):
        assert _rel(getattr(st.data, attr), getattr(sj.data, attr)) <= 1e-10
