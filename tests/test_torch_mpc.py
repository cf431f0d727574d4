"""Robust-CSTR MPC of the PyTorch port against the JAX package (float64, CPU).

* the NLP oracles f, g, h, grad_f, jac_g, jac_h and the Lagrangian Hessian
  at random (w, lambda), 1e-12;
* one ``make_step`` at N=10 from the same numeric state
  (``interop.load_mpc_state``), u0 within the reference suite's 1e-8
  (BASELINE.md:15) at the same iteration count;
* the package's import boundary: no ``jax`` and no ``dompc_tpu`` anywhere in
  ``dompc_tpu_torch``;
* the settings the port refuses, and the device and dtype rules.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from __graft_entry__ import _build_cstr_mpc  # noqa: E402
import dompc_tpu_torch  # noqa: E402
from dompc_tpu_torch import _config  # noqa: E402
from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0  # noqa: E402
from dompc_tpu_torch.interop import (mpc_state_arrays,  # noqa: E402
                                     load_mpc_state)
from dompc_tpu_torch.solver.ipm import (make_ipm_solver,  # noqa: E402
                                        IPMSettings)


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    # one intra-op thread: test workers running side by side would
    # otherwise each spin a pool over all the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mpcs(_cpu_port):
    mj = _build_cstr_mpc(n_horizon=10)
    mj.x0 = CSTR_X0
    mj.set_initial_guess()
    mt = cstr_robust_mpc(n_horizon=10)
    load_mpc_state(mt, mpc_state_arrays(mj))
    return mj, mt


@pytest.fixture(scope="module")
def point(mpcs):
    mj, _ = mpcs
    rng = np.random.default_rng(0)
    w = np.asarray(mj.opt_x_num) * (1 + 0.05 * rng.standard_normal(
        mj.n_opt_x))
    pvec = mj._assemble_opt_p(CSTR_X0 * 1.01)
    lam_g = rng.standard_normal(mj.n_opt_lagr)
    lam_h = rng.standard_normal(mj._n_ineq)
    return w, pvec, lam_g, lam_h


_ORACLES = {"f": ("_f_fn", 2), "g": ("_g_fn", 2), "h": ("_h_fn", 2),
            "grad_f": ("_grad_f_fn", 2), "jac_g": ("_jac_g_fn", 2),
            "jac_h": ("_jac_h_fn", 2), "hess": ("_hess_fn", 4)}


@pytest.mark.parametrize("name", sorted(_ORACLES))
def test_nlp_oracle_matches_jax(mpcs, point, name):
    mj, mt = mpcs
    attr, n_args = _ORACLES[name]
    args = point[:n_args]
    ref = np.asarray(jax.jit(getattr(mj, attr))(
        *[jnp.asarray(a) for a in args]))
    got = getattr(mt, attr)(*[torch.as_tensor(a) for a in args]).numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-12 * scale


def test_make_step_matches_jax(mpcs):
    """One robust-CSTR step from the same state: the same iterations and
    u0 within BASELINE.md:15's 1e-8 (measured agreement ~1e-13)."""
    mj, mt = mpcs
    load_mpc_state(mt, mpc_state_arrays(mj))
    u_j = mj.make_step(CSTR_X0)
    u_t = mt.make_step(CSTR_X0)
    assert mt.solver_stats["success"] and mj.solver_stats["success"]
    assert mt.solver_stats["iter_count"] == mj.solver_stats["iter_count"]
    assert float(np.abs(u_t - u_j).max()) < 1e-8
    assert float(np.abs(mt.opt_x_num - np.asarray(mj.opt_x_num)).max()) \
        < 1e-8
    np.testing.assert_allclose(mt.data["_u"], mj.data["_u"], atol=1e-8)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_source_imports_no_jax():
    files = sorted((ROOT / "dompc_tpu_torch").rglob("*.py"))
    assert files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dompc_tpu"), (path, mod)


def test_import_leaves_no_jax_module():
    # modules a site hook loaded before the import are not the package's
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import dompc_tpu_torch, dompc_tpu_torch.systems, "
            "dompc_tpu_torch.interop\n"
            "bad = [m for m in set(sys.modules) - before\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'dompc_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=300)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_device_and_dtype_rules(monkeypatch):
    monkeypatch.delenv("DOMPC_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        _config.resolve_device()
    monkeypatch.setenv("DOMPC_TPU_PLATFORM", "cpu")
    assert _config.resolve_device() == torch.device("cpu")
    monkeypatch.delenv("DOMPC_TPU_X64")
    assert _config.resolve_dtype() == torch.float32
    monkeypatch.setenv("DOMPC_TPU_X64", "1")
    assert _config.resolve_dtype() == torch.float64


def test_ipm_solver_device_and_dtype_rules(monkeypatch):
    """make_ipm_solver called without a device or dtype takes both from the
    environment, and wants CUDA unless the CPU is asked for."""
    def build():
        return make_ipm_solver(lambda w, p: ((w - 0.25) ** 2).sum(-1), None,
                               None, np.zeros(2), np.ones(2), 0, 0)

    monkeypatch.delenv("DOMPC_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build()
    monkeypatch.setenv("DOMPC_TPU_PLATFORM", "cpu")
    for x64, dtype in (("0", torch.float32), ("1", torch.float64)):
        monkeypatch.setenv("DOMPC_TPU_X64", x64)
        # a float32 start: the bounds' dtype decides the iterates' dtype
        sol = build()(torch.full((1, 2), 0.5), torch.zeros(1, 0))
        assert sol.w.dtype == dtype and sol.w.device.type == "cpu"
        assert bool(sol.success)
        assert float((sol.w - 0.25).abs().max()) < 1e-4


@pytest.mark.parametrize("setting", [
    ("rti_iters", 2), ("globalization", "merit"), ("cold_dual_init", True),
    ("dual_refit", True), ("n_refine_kkt", 1), ("tol_loop", 1e-5),
    ("dynamic_bounds", True)])
def test_unported_settings_raise(setting):
    """The settings still unported raise; ``rti_iters`` and ``tol_loop``
    (ported with the RTI modes, tests/test_torch_rti.py) build."""
    name, value = setting
    kw, st = {}, IPMSettings()
    if name == "dynamic_bounds":
        kw[name] = value
    else:
        st = IPMSettings(**{name: value})

    def build():
        make_ipm_solver(lambda w, p: w.sum(-1), None, None, np.zeros(2),
                        np.ones(2), 0, 0, settings=st, **kw)
    if name in ("rti_iters", "tol_loop"):
        build()
        return
    with pytest.raises(NotImplementedError):
        build()
