"""The plain reference against the port on the CPU in float64: the same
layout, bounds, objective and constraints at the configurations' own
sizes, and the same KKT error at a point the port's solver certified."""
import importlib

import numpy as np
import pytest
import torch

from portbench.harness import registry
from portbench.reference.kkt import kkt_error
from portbench.reference.ocp import Transcription

CONFIGS = ["cstr_robust_n20_f32", "poly_robust_n20_f32"]


@pytest.fixture
def port_f64(monkeypatch):
    monkeypatch.setenv("DOMPC_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("DOMPC_TPU_X64", "1")


def _build(name, n_horizon=None):
    from portbench.harness.program import Program
    cfg = registry.load_json(registry.ROOT / "portbench" / "configs"
                             / f"{name}.json")
    ocp = dict(cfg["ocp"])
    if n_horizon:
        ocp["n_horizon"] = n_horizon
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    return cfg, ref, Transcription(ocp, ref), Program(cfg, n_horizon)


def _pvec(mpc, x0s):
    pv = torch.as_tensor(mpc._assemble_opt_p(np.zeros(x0s.shape[1])))
    pv = pv[None].repeat(x0s.shape[0], 1)
    pv[:, mpc._p_sl["x0"]] = torch.as_tensor(x0s)
    return pv


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_nlp_is_the_ports(name, port_f64):
    cfg, ref, tr, prog = _build(name)
    mpc = prog.mpc
    assert (tr.n, tr.m, tr.q) == (mpc.n_opt_x, mpc.n_opt_lagr, mpc._n_ineq)
    assert tr.n == cfg["sizes"]["variables"]
    assert np.array_equal(tr.lb, mpc._lb_opt_x)
    assert np.array_equal(tr.ub, mpc._ub_opt_x)
    assert np.array_equal(tr.u0_idx, mpc.layout.idx(("u", 0, 0)))
    rng = np.random.default_rng(0)
    x0 = ref.complete_state(np.array(cfg["x_nominal"])[None])
    x0s = x0 * (1 + 0.01 * rng.standard_normal((3, x0.shape[1])))
    w = torch.as_tensor(prog.cold_guess(x0s)
                        * (1 + 0.05 * rng.standard_normal((3, tr.n))))
    pv = _pvec(mpc, x0s)
    fr, gr, hr = tr.functions(w, torch.as_tensor(x0s))
    for got, want in ((mpc._f_fn(w, pv), fr), (mpc._g_fn(w, pv), gr),
                      (mpc._h_fn(w, pv), hr)):
        assert got.shape == want.shape
        if not want.numel():
            continue
        scale = 1.0 + want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-13


def test_reference_kkt_error_is_the_solvers(port_f64):
    """At a point the port's solver returns, the reference's float64 KKT
    error equals the one the solver certified by."""
    cfg, ref, tr, prog = _build("cstr_robust_n20_f32", n_horizon=5)
    x0s = np.array(cfg["x_nominal"])[None] * np.array([[1.0], [1.01]])
    solve = prog.solver(tol=1e-6)
    sol, _ = solve(x0s, prog.cold_guess(x0s))
    assert bool(sol.success.all())
    err = kkt_error(tr, torch.as_tensor(x0s), sol.w, sol.s, sol.lam,
                    sol.zl, sol.zu)[0]
    assert torch.allclose(err, sol.kkt_err.to(err.dtype), rtol=1e-6,
                          atol=1e-14)
