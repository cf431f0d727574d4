"""The port's ``make_batch_solver`` against the JAX package's without
``throughput_mode`` (float64, CPU): the regularization ladder, the
second-order correction, restoration, the polish and three refinement
passes of the band solve, batched.

B=2 robust CSTR at N=5, cold then warm: u0 within 1e-8 relative
(BASELINE.md:15) at equal iterations.  ``reg_retries=1`` keeps one rung of
the ladder: JAX compiles every rung into its vmapped program, and the
default five take the compile from ~30 s to ~150 s on the CPU.  (The
throughput-mode comparison and the rest of the batched path's checks are
in ``tests/test_torch_batch.py``.)
"""
from test_torch_batch import _against_jax, _cpu_port, mpcs  # noqa: F401


def test_batch_solver_matches_jax_full_mode(mpcs):  # noqa: F811
    _against_jax(mpcs, throughput_mode=False, reg_retries=1)
