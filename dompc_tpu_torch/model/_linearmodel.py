"""LTI model subclass (PyTorch port of the JAX package's
``model/_linearmodel.py``; reference: do_mpc/model/_linearmodel.py:35-326).
The system matrices are numpy arrays; the model's flat functions are torch
like every :class:`Model`'s."""
from __future__ import annotations

import numpy as np
import torch

from ._model import Model
from .. import sym as casym


def _packed(spec, var_type):
    """Sym of a variable group's flat vector (an empty group's in the
    evaluation's dtype and device)."""
    def fn(env):
        if spec.size:
            return spec.pack(env[var_type], xp=torch)
        dtype, device = env[casym.META]
        return torch.zeros((0,), dtype=dtype, device=device)
    return casym.Sym(fn)


class LinearModel(Model):
    """Linear time-invariant model.

    Two setup paths like the reference: (a) declare variables + ``set_rhs``
    with linear expressions then ``setup()`` (linearity verified by Jacobian
    constancy, ref :145-159); (b) declare variables then ``setup(A, B, C, D)``
    (ref :171)."""

    def __init__(self, model_type: str = None, symvar_type: str = "SX"):
        if symvar_type == "MX":
            raise ValueError(
                "class LinearModel can be initialized only with SX variable.")
        super().__init__(model_type, symvar_type)

    # properties (reference :104-134)
    @property
    def sys_A(self): return self._A
    @property
    def sys_B(self): return self._B
    @property
    def sys_C(self): return self._C
    @property
    def sys_D(self): return self._D

    def set_alg(self, expr_name, expr):  # reference :164
        raise RuntimeError("Algebraic states are not supported for LinearModel.")

    def setup(self, A=None, B=None, C=None, D=None):
        if A is not None:
            A = np.atleast_2d(np.asarray(A, dtype=float))
            n_x = A.shape[0]
            B = (np.zeros((n_x, 0)) if B is None
                 else np.atleast_2d(np.asarray(B, dtype=float)))
            # build rhs from matrices over the declared (or implicit) variables
            assert self._specs["_x"].size == n_x, (
                "Declared states do not match A matrix size.")
            xs = _packed(self._specs["_x"], "_x")
            us = _packed(self._specs["_u"], "_u")
            rhs_full = casym.mtimes(A, xs) + casym.mtimes(B, us)
            off = 0
            for name in self._specs["_x"].names:
                n = self._specs["_x"].block_size(name)
                super().set_rhs(name, rhs_full[off:off + n])
                off += n
            if C is not None:
                C = np.atleast_2d(np.asarray(C, dtype=float))
                D_ = (np.zeros((C.shape[0], self._specs["_u"].size))
                      if D is None else np.atleast_2d(np.asarray(D, dtype=float)))
                y_expr = casym.mtimes(C, xs) + casym.mtimes(D_, us)
                self.set_meas("y", y_expr, meas_noise=False)
        super().setup()
        # numeric system matrices via autodiff (constant for linear models)
        A_, B_, C_, D_ = self.get_linear_system_matrices()
        self._A, self._B, self._C, self._D = A_, B_, C_, D_
        # verify linearity: Jacobians at a second random point must match
        rng = np.random.default_rng(0)
        A2, B2, _, _ = self.get_linear_system_matrices(
            rng.normal(size=self.n_x), rng.normal(size=self.n_u))
        if not (np.allclose(A_, A2) and np.allclose(B_, B2)):
            raise RuntimeError("Provided rhs is not linear in (x, u).")
        return self

    def discretize(self, t_step: float, conv_method: str = "zoh"):
        """Exact ZOH discretization (reference :245 uses
        scipy.signal.cont2discrete); here via the matrix exponential of the
        augmented block matrix."""
        assert self.model_type == "continuous", "Model is already discrete."
        import scipy.linalg
        n_x, n_u = self.n_x, self.n_u
        M = np.zeros((n_x + n_u, n_x + n_u))
        M[:n_x, :n_x] = self._A
        M[:n_x, n_x:] = self._B
        E = scipy.linalg.expm(M * t_step)
        Ad = E[:n_x, :n_x]
        Bd = E[:n_x, n_x:]
        m = LinearModel("discrete")
        for name in self._specs["_x"].names:
            m.set_variable("_x", name, self._specs["_x"].shapes[name])
        for name in self._specs["_u"].names:
            m.set_variable("_u", name, self._specs["_u"].shapes[name])
        m.setup(Ad, Bd, self._C if self.n_y else None,
                self._D if self.n_y else None)
        return m

    def get_steady_state(self, xss=None, uss=None):
        """Steady state for given input or state ((I-A)^-1 B u for discrete,
        -A^-1 B u for continuous; reference :282)."""
        A, B = self._A, self._B
        if uss is not None:
            uss = np.asarray(uss, dtype=float).reshape(-1)
            if self.model_type == "discrete":
                xss = np.linalg.solve(np.eye(self.n_x) - A, B @ uss)
            else:
                xss = np.linalg.solve(-A, B @ uss)
            return xss.reshape(-1, 1)
        elif xss is not None:
            xss = np.asarray(xss, dtype=float).reshape(-1)
            if self.model_type == "discrete":
                uss, *_ = np.linalg.lstsq(B, (np.eye(self.n_x) - A) @ xss,
                                          rcond=None)
            else:
                uss, *_ = np.linalg.lstsq(B, -A @ xss, rcond=None)
            return uss.reshape(-1, 1)
        raise ValueError("Provide xss or uss.")
