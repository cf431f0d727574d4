"""Discrete LTI LQR (PyTorch port of the JAX package's ``controller/_lqr.py``;
reference: do_mpc/controller/_lqr.py:33-498).  The gain is host numpy, as
there: an LQR step is one small matrix-vector product."""
from __future__ import annotations

import warnings

import numpy as np

from ..model._iteratedvariables import IteratedVariables
from ..model._linearmodel import LinearModel
from ..data import Data
from ._controllersettings import LQRSettings


def _solve_dare(A, B, Q, R, iters=200, tol=1e-14):
    """Discrete algebraic Riccati equation by the structure-preserving
    doubling algorithm (replaces scipy.linalg.solve_discrete_are used at
    reference :174; pure numpy, quadratically convergent)."""
    G = B @ np.linalg.solve(R, B.T)
    Ak = A.copy()
    Gk = G.copy()
    Hk = Q.copy()
    I = np.eye(A.shape[0])
    for _ in range(iters):
        W = I + Gk @ Hk
        W_inv_Ak = np.linalg.solve(W, Ak)
        W_inv_Gk = np.linalg.solve(W, Gk)
        Ak_new = Ak @ W_inv_Ak
        Gk_new = Gk + Ak @ W_inv_Gk @ Ak.T
        Hk_new = Hk + W_inv_Ak.T @ Hk @ Ak
        if np.max(np.abs(Hk_new - Hk)) < tol * max(1.0, np.max(np.abs(Hk))):
            Hk = Hk_new
            break
        Ak, Gk, Hk = Ak_new, Gk_new, Hk_new
    return Hk


class LQR(IteratedVariables):
    """Linear quadratic regulator for discrete LinearModels."""

    def __init__(self, model):
        assert isinstance(model, LinearModel), \
            "LQR can only be used with LinearModel."
        assert model.flags["setup"], "Model must be setup."
        assert model.model_type == "discrete", (
            "Initialize LQR with a discrete system "
            "(use LinearModel.discretize()).")
        self._init_iterated_variables(model)
        self.data = Data(model)
        self.settings = LQRSettings()
        self.mode = "standard"
        self.flags = {"setup": False}
        self.Q = np.zeros((0, 0))
        self.R = np.zeros((0, 0))
        self.P = None

    def reset_history(self):
        self._t0 = np.array([0.0])
        self.data.init_storage()

    def set_param(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(self.settings, k):
                setattr(self.settings, k, v)

    def set_objective(self, Q=None, R=None, P=None):
        """Cost matrices (reference :330-420)."""
        assert not self.flags["setup"], "Objective cannot be set after setup."
        self.Q = np.asarray(Q, dtype=float)
        self.R = np.asarray(R, dtype=float)
        if P is None and self.settings.n_horizon is not None:
            self.P = self.Q.copy()
            warnings.warn("P not given; using Q as terminal cost.")
        elif P is not None:
            self.P = np.asarray(P, dtype=float)
        n_x, n_u = self.model.n_x, self.model.n_u
        assert self.Q.shape == (n_x, n_x)
        assert self.R.shape == (n_u, n_u)

    def set_rterm(self, delR):
        """Switch to input-rate penalization: augmented state [x; u], input
        delta-u (reference :178-226)."""
        A, B = self.model.sys_A, self.model.sys_B
        n_u = B.shape[1]
        self.A_rated = np.block([
            [A, B], [np.zeros((n_u, A.shape[1])), np.eye(n_u)]])
        self.B_rated = np.block([[B], [np.eye(n_u)]])
        self.delR = np.asarray(delR, dtype=float)
        self.mode = "inputRatePenalization"

    def discrete_gain(self, A, B):
        """Finite-horizon backward Riccati or infinite-horizon DARE
        (reference :127-176)."""
        assert self.Q.size and self.R.size, "Set Q and R via set_objective()."
        if self.settings.n_horizon is not None:
            P = self.P
            for _ in range(self.settings.n_horizon):
                K = -np.linalg.solve(B.T @ P @ B + self.R, B.T @ P @ A)
                P = self.Q + A.T @ P @ A \
                    - A.T @ P @ B @ np.linalg.solve(
                        B.T @ P @ B + self.R, B.T @ P @ A)
            return K
        P = _solve_dare(A, B, self.Q, self.R)
        return -np.linalg.solve(B.T @ P @ B + self.R, B.T @ P @ A)

    def setup(self):
        """Compute the gain (reference :471-498)."""
        self.settings.check_for_mandatory_settings()
        if self.mode in ("standard", None):
            self.K = self.discrete_gain(self.model.sys_A, self.model.sys_B)
        elif self.mode == "inputRatePenalization":
            zQ = np.zeros((self.Q.shape[0], self.R.shape[1]))
            zR = np.zeros((self.R.shape[0], self.Q.shape[1]))
            self.Q = np.block([[self.Q, zQ], [zR, self.R]])
            if self.settings.n_horizon is not None:
                self.P = np.block([[self.P, zQ], [zR, self.R]])
            self.R = self.delR
            self.K = self.discrete_gain(self.A_rated, self.B_rated)
        self.flags["setup"] = True
        return self

    def set_setpoint(self, xss=None, uss=None):
        """Reference :424-470."""
        assert self.flags["setup"], "LQR is not setup."
        n_x, n_u = self.model.n_x, self.model.n_u
        if isinstance(xss, np.ndarray):
            self.xss = xss.reshape(-1, 1)
        elif not hasattr(self, "xss"):
            self.xss = np.zeros((n_x, 1))
        if isinstance(uss, np.ndarray):
            self.uss = uss.reshape(-1, 1)
        elif not hasattr(self, "uss"):
            self.uss = np.zeros((n_u, 1))
        if self.mode == "inputRatePenalization":
            self.xss = np.block([[self.xss], [self.uss]])
            self.uss = np.zeros((n_u, 1))

    def make_step(self, x0) -> np.ndarray:
        """u0 = K (x - xss) + uss (reference :270-319)."""
        assert self.flags["setup"], "LQR is not setup."
        x0 = np.asarray(x0, dtype=float).reshape(-1, 1)
        if not hasattr(self, "xss"):
            self.set_setpoint()
        u_prev = self._u0.data.reshape(-1, 1)
        if self.mode == "standard":
            u0 = self.K @ (x0 - self.xss) + self.uss
        else:
            x0_aug = np.block([[x0], [u_prev]])
            u0 = self.K @ (x0_aug - self.xss) + self.uss
            u0 = u0 + u_prev

        self.data.update(_x=x0)
        self.data.update(_u=u0)
        self.data.update(_time=self._t0)
        self._t0 = self._t0 + self.settings.t_step
        self._x0.data[:] = x0.reshape(-1)
        self._u0.data[:] = u0.reshape(-1)
        return u0
