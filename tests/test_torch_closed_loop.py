"""The closed loop of the PyTorch port against the JAX package (float64,
CPU): the robust CSTR flagship at N=3, ``u0 = mpc.make_step(x0); y =
sim.make_step(u0)`` for 3 steps in each package from the same state, u0
and the plant within 1e-8 at equal iterations.

A file of its own (moved from ``tests/test_torch_simulator.py``, where it
ran at N=5): its JAX compile is most of that file's time, and a file of
three items or fewer is scheduled after the JAX package's long
``tests/test_mhe_p_est_bounds.py`` under ``pytest -n 6 --dist loadfile``,
which orders files by their number of items.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from __graft_entry__ import _build_cstr_mpc  # noqa: E402
import dompc_tpu.systems as jsys  # noqa: E402
import dompc_tpu_torch.systems as tsys  # noqa: E402
from dompc_tpu_torch.interop import (load_mpc_state,  # noqa: E402
                                     mpc_state_arrays)

X_CSTR = np.array([0.8, 0.5, 134.14, 130.0])


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


def test_closed_loop_make_step_and_simulator_match_jax():
    """The flagship at N=3: u0 = mpc.make_step(x0); y = sim.make_step(u0),
    3 steps in each package from the same state."""
    mj = _build_cstr_mpc(n_horizon=3)
    mj.x0 = X_CSTR
    mj.set_initial_guess()
    mt = tsys.cstr_robust_mpc(n_horizon=3)
    load_mpc_state(mt, mpc_state_arrays(mj))
    loops = []
    for mpc, pkg in ((mj, jsys), (mt, tsys)):
        sim = pkg.cstr_simulator(pkg.cstr_model())
        sim.x0 = X_CSTR
        x, rows = X_CSTR.copy(), []
        for _ in range(3):
            u = mpc.make_step(x)
            x = sim.make_step(u).ravel()
            rows.append((np.asarray(u).ravel(), x,
                         mpc.solver_stats["iter_count"],
                         mpc.solver_stats["success"]))
        loops.append(rows)
    for (u_j, x_j, it_j, ok_j), (u_t, x_t, it_t, ok_t) in zip(*loops):
        assert ok_t and ok_j and it_t == it_j
        assert _rel(u_t, u_j) <= 1e-8 and _rel(x_t, x_j) <= 1e-8
