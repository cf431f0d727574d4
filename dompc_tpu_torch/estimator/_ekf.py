"""Extended Kalman filter (PyTorch port of the JAX package's
``estimator/_ekf.py``; reference: do_mpc/estimator/_ekf.py:33-471).

Continuous models propagate the augmented state [x; vec(P)] with dP/dt =
A P + P A^T + Q through the adaptive Radau integrator (the reference runs
IDAS), A(x) by ``torch.func.jacfwd`` along the trajectory; discrete models
take P+ = A P A^T + Q.  The gain L = P C^T (C P C^T + R)^-1 and the update
are host-side float64 numpy, as in the JAX package.  The model functions
run on the device and in the dtype of ``resolve_device``/``resolve_dtype``
(read at ``setup()``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._config import resolve_device, resolve_dtype
from ._base import Estimator
from ..tools import NumStruct
from ..ops.integrators import (make_adaptive_dae_integrator,
                               make_ode_integrator)


@dataclass
class EKFSettings:
    """``abstol/reltol`` are honored by the continuous-time covariance
    propagation (the augmented ODE integrates with the Simulator's adaptive
    Radau IIA).  ``adaptive=False`` takes the fixed ``substeps`` stepper."""
    t_step: float | None = None
    abstol: float = 1e-10
    reltol: float = 1e-10
    adaptive: bool = True
    substeps: int = 4   # fixed mode: substeps; adaptive: initial substeps

    def check_for_mandatory_settings(self):
        assert self.t_step is not None, "t_step must be set."


class EKF(Estimator):
    def __init__(self, model):
        super().__init__(model)
        assert model.n_z == 0, "EKF with algebraic equations not supported."
        self.settings = EKFSettings()
        self.flags = {"setup": False, "set_tvp_fun": False,
                      "set_p_fun": False, "set_initial_guess": False,
                      "first_step": True}
        self.tvp_fun = None
        self.p_fun = None
        self._P0 = None

    @property
    def P0(self):
        return self._P0

    @P0.setter
    def P0(self, val):
        val = np.asarray(val, dtype=float)
        assert val.shape == (self.model.n_x, self.model.n_x)
        self._P0 = val

    def get_tvp_template(self):
        return NumStruct(self.model.spec("_tvp"))

    def set_tvp_fun(self, fun):
        self.tvp_fun = fun
        self.flags["set_tvp_fun"] = True

    def get_p_template(self):
        return NumStruct(self.model.spec("_p"))

    def set_p_fun(self, fun):
        self.p_fun = fun
        self.flags["set_p_fun"] = True

    def setup(self):
        self.settings.check_for_mandatory_settings()
        model = self.model
        self._device = resolve_device()
        self._dtype = resolve_dtype()
        if self.tvp_fun is None:
            tmpl = self.get_tvp_template()
            self.set_tvp_fun(lambda t: tmpl)
        if self.p_fun is None:
            tmpl = self.get_p_template()
            self.set_p_fun(lambda t: tmpl)
        n_x = model.n_x

        def rhs(x, u, tvp, p):
            return model._rhs_fun(x, u, x.new_zeros((0,)), tvp, p,
                                  x.new_zeros((model.n_w,)))

        def meas(x, u, tvp, p):
            return model._meas_fun(x, u, x.new_zeros((0,)), tvp, p,
                                   x.new_zeros((model.n_v,)))

        # in x's dtype: forward mode can promote a float32 Jacobian to
        # float64 (a 0-d tensor times a Python float, under vmap)
        def A_of(x, u, tvp, p):
            return torch.func.jacfwd(lambda xx: rhs(xx, u, tvp, p))(x).to(
                x.dtype)

        def C_of(x, u, tvp, p):
            return torch.func.jacfwd(lambda xx: meas(xx, u, tvp, p))(x).to(
                x.dtype)

        self._rhs, self._meas, self._A_of, self._C_of = rhs, meas, A_of, C_of
        self._stepper = None
        if model.model_type == "continuous":
            def aug_rhs(xp, args):
                u, tvp, p, Q = args
                x = xp[:n_x]
                P = xp[n_x:].reshape(n_x, n_x)
                A = A_of(x, u, tvp, p)
                dP = A @ P + P @ A.T + Q
                return torch.cat([rhs(x, u, tvp, p), dP.reshape(-1)])

            st = self.settings
            if st.adaptive:
                adaptive = make_adaptive_dae_integrator(
                    lambda x, z, args: aug_rhs(x, args),
                    lambda x, z, args: x.new_zeros((0,)),
                    n_z=0, abstol=st.abstol, reltol=st.reltol,
                    init_substeps=st.substeps)
                self._stepper = adaptive

                def step(xp, args, h):
                    x, _ = adaptive(xp, xp.new_zeros((0,)), args, h)
                    return x
            else:
                step = make_ode_integrator(aug_rhs, method="radau",
                                           substeps=st.substeps)
            self._xp_step = lambda xp, u, tvp, p, Q: step(
                xp, (u, tvp, p, Q), self.settings.t_step)

        if self._P0 is None:
            self._P0 = np.eye(n_x)
        self.flags["setup"] = True
        return self

    @property
    def adaptive_steps(self):
        """Steps (accepted and rejected) of the covariance propagation in
        the last ``make_step``; None for discrete models and fixed steps."""
        return None if self._stepper is None else self._stepper.last_steps

    def set_initial_guess(self):
        assert self.flags["setup"], "EKF was not setup yet."
        self.flags["set_initial_guess"] = True

    def _num(self, v):
        if isinstance(v, NumStruct):
            return v.data
        return np.asarray(v, dtype=float).reshape(-1)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    @staticmethod
    def _host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    def make_step(self, y_next, u_next, Q_k, R_k) -> np.ndarray:
        """Predict + update (reference: _ekf.py:231-329)."""
        assert self.flags["setup"], "EKF was not setup yet."
        model = self.model
        T, H = self._tensor, self._host
        Q_k = np.asarray(Q_k, dtype=float)
        R_k = np.asarray(R_k, dtype=float)
        assert Q_k.shape == (model.n_x, model.n_x)
        assert R_k.shape == (model.n_y, model.n_y)
        y_next = self._num(y_next)
        u_next = self._num(u_next)
        t0 = self._t0
        tvp0 = self._num(self.tvp_fun(float(t0[0]))) if model.n_tvp \
            else np.zeros(0)
        p0 = self._num(self.p_fun(float(t0[0]))) if model.n_p \
            else np.zeros(0)
        x0 = self._x0.data.copy()
        P0 = self._P0
        self._t0 = self._t0 + self.settings.t_step

        args = (T(u_next), T(tvp0), T(p0))
        A_k = H(self._A_of(T(x0), *args))
        C_k = H(self._C_of(T(x0), *args))

        if model.model_type == "continuous":
            xp0 = T(np.concatenate([x0, P0.reshape(-1)]))
            sol = H(self._xp_step(xp0, *args, T(Q_k)))
            x_apriori = sol[:model.n_x]
            P0 = sol[model.n_x:].reshape(model.n_x, model.n_x)
        else:
            x_apriori = H(self._rhs(T(x0), *args))
            P0 = A_k @ P0 @ A_k.T + Q_k
        y_apriori = H(self._meas(T(x_apriori), *args))

        L = P0 @ C_k.T @ np.linalg.inv(C_k @ P0 @ C_k.T + R_k)
        x0 = x_apriori + L @ (y_next - y_apriori)
        P0 = (np.eye(model.n_x) - L @ C_k) @ P0

        self._x0.data[:] = x0
        self._P0 = P0
        self.data.update(_x=x0)
        self.data.update(_u=u_next)
        if model.n_p:
            self.data.update(_p=p0)
        if model.n_tvp:
            self.data.update(_tvp=tvp0)
        # the reference logs the post-increment time (numpy aliasing of t0
        # with self._t0, _ekf.py:278 vs :324); replicated for parity
        self.data.update(_time=self._t0)
        return x0.reshape(-1, 1)
