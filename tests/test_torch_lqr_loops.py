"""The LQR loops and a DAE conversion of the PyTorch port against the
JAX package (float64, CPU), with the helpers of ``tests/test_torch_lqr.py``:

* the CSTR LQR (``tests/test_more_examples.py:95-125``), 5 steps;
* the batch reactor (``tests/test_more_examples.py:128-163``:
  ``dae2odeconversion`` -> ``linearize`` -> ``discretize`` -> LQR), 10
  steps;
* ``dae2odeconversion`` of the double inverted pendulum (parameters,
  time-varying parameters, vector states) at a seeded point;

within 1e-10 relative.  A file of its own (moved from
``tests/test_torch_lqr.py``): three items, so that under ``pytest -n 6
--dist loadfile`` (files ordered by their number of items) they run after
the JAX package's long ``tests/test_mhe_p_est_bounds.py`` has started.
"""
import numpy as np
import torch

import dompc_tpu as jdm
import dompc_tpu_torch as tdm
from test_torch_lqr import (TOL, _batch_reactor_lqr_loop,  # noqa: F401
                            _cpu_port, _cstr_lqr_loop, _rel, _same_loop)


def test_cstr_lqr_closed_loop_matches_jax():
    lin_j, dc_j, lqr_j, sim_j = _cstr_lqr_loop(jdm, 5)
    lin_t, dc_t, lqr_t, sim_t = _cstr_lqr_loop(tdm, 5)
    assert isinstance(lin_t, tdm.model.LinearModel)
    assert lqr_t.mode == "inputRatePenalization"
    _same_loop(lin_j, lin_t, lqr_j, lqr_t, sim_j, sim_t)
    _same_loop(dc_j, dc_t, lqr_j, lqr_t, sim_j, sim_t)


def test_batch_reactor_dae2ode_lqr_matches_jax():
    dae_j, lin_j, lqr_j, sim_j = _batch_reactor_lqr_loop(jdm, 10)
    dae_t, lin_t, lqr_t, sim_t = _batch_reactor_lqr_loop(tdm, 10)
    # the converted right-hand side and its Jacobians at a random point
    rng = np.random.default_rng(4)
    x, q = rng.standard_normal(5), rng.standard_normal(1)
    for fn in ("A", "B"):
        mats = [m.get_linear_system_matrices(x, q)[fn == "B"]
                for m in (dae_j, dae_t)]
        assert _rel(mats[1], mats[0]) <= TOL, fn
    f_t = dae_t._rhs_fun(*(torch.as_tensor(v) for v in
                           (x, q, np.zeros(0), np.zeros(0), np.zeros(0),
                            np.zeros(0))))
    f_j = dae_j._rhs_fun(x, q, np.zeros(0), np.zeros(0), np.zeros(0),
                         np.zeros(0))
    assert _rel(f_t.numpy(), f_j) <= TOL
    _same_loop(lin_j, lin_t, lqr_j, lqr_t, sim_j, sim_t)


def test_dae2ode_with_parameters_matches_jax():
    """dae2odeconversion of a DAE with parameters, time-varying parameters
    and matrix-shaped states (the double inverted pendulum): the converted
    right-hand side and its Jacobians at a seeded point."""
    import dompc_tpu.systems as jsys
    import dompc_tpu_torch.systems as tsys
    conv = [dm.model.dae2odeconversion(sysmod.dip_model())
            for dm, sysmod in ((jdm, jsys), (tdm, tsys))]
    rng = np.random.default_rng(6)
    x, q = rng.standard_normal(conv[0].n_x), rng.standard_normal(1)
    p, tvp = np.array([0.2, 0.25]), np.array([-0.8])
    w = np.zeros(conv[0].n_w)
    f_j = conv[0]._rhs_fun(x, q, np.zeros(0), tvp, p, w)
    f_t = conv[1]._rhs_fun(*(torch.as_tensor(v) for v in
                             (x, q, np.zeros(0), tvp, p, w)))
    assert _rel(f_t.numpy(), f_j) <= TOL
    for j, t in zip(conv[0].get_linear_system_matrices(x, q, pss=p,
                                                       tvpss=tvp),
                    conv[1].get_linear_system_matrices(x, q, pss=p,
                                                       tvpss=tvp)):
        assert _rel(t, j) <= TOL
