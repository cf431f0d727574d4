"""``MPC.make_step`` of the PyTorch port with ``solver_rti_iters=2`` and
with ``solver_tol_loop`` against the JAX package's (float64, CPU), on the
oscillating masses of ``tests/test_torch_rti.py`` (its helpers): per step
equal iterations and success, u0 and the solution within 1e-8.

A file of its own (moved from ``tests/test_torch_rti.py``): two items, so
that under ``pytest -n 6 --dist loadfile`` (files ordered by their number
of items) they run after the JAX package's long
``tests/test_mhe_p_est_bounds.py`` has started.
"""
from test_torch_rti import _cpu_port, _make_steps, _pair  # noqa: F401


def test_make_step_rti_matches_jax(_cpu_port):
    mj, mt = _make_steps(*_pair(solver_rti_iters=2))
    assert mt.solver_stats["iter_count"] == 2     # the warm step


def test_make_step_tol_loop_matches_jax(_cpu_port):
    mj, mt = _make_steps(*_pair(solver_tol=1e-8, solver_tol_loop=1e-4))
    assert mt.solver_stats["success"]
