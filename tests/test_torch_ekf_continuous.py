"""The extended Kalman filter of the PyTorch port against the JAX
package's on a continuous model (float64, CPU): the CSTR, whose covariance
propagates through the adaptive Radau integrator with a ``jacfwd`` nested
in the stage Jacobian, 2 steps within 1e-9 of JAX.

A file of its own (moved from ``tests/test_torch_ekf.py``): its JAX
compile is most of that file's time, and a file of three items or fewer
is scheduled after the JAX package's long ``tests/test_mhe_p_est_bounds.py``
under ``pytest -n 6 --dist loadfile``, which orders files by their number
of items.
"""
import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems as jsys
import dompc_tpu_torch as tdm
import dompc_tpu_torch.systems as tsys


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


def _cstr_ekf(dm, systems):
    model = systems.cstr_model()
    ekf = dm.estimator.EKF(model)
    ekf.settings.t_step = 0.005
    p = ekf.get_p_template()
    p["alpha"] = 1.0
    p["beta"] = 1.0
    ekf.set_p_fun(lambda t: p)
    ekf.setup()
    ekf.x0 = np.array([0.8, 0.5, 134.14, 130.0])
    ekf.P0 = np.diag([0.01, 0.01, 1.0, 1.0])
    ekf.set_initial_guess()
    return ekf


def test_continuous_ekf_matches_jax():
    Q = np.diag([1e-4, 1e-4, 1e-2, 1e-2])
    R = np.diag([1e-3, 1e-3, 1e-1, 1e-1])
    u = np.array([[18.0], [-4500.0]])
    ys = [np.array([0.85, 0.52, 134.0, 129.8]),
          np.array([0.9, 0.55, 133.9, 129.6])]
    out = []
    for dm, systems in ((jdm, jsys), (tdm, tsys)):
        ekf = _cstr_ekf(dm, systems)
        for y in ys:
            ekf.make_step(y_next=y, u_next=u, Q_k=Q, R_k=R)
        out.append(ekf)
    assert _rel(out[1].data._x, out[0].data._x) <= 1e-9
    assert _rel(out[1].P0, out[0].P0) <= 1e-9
    assert out[1].adaptive_steps >= 1
