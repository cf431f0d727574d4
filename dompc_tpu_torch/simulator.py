"""Plant simulator (PyTorch port of the JAX package's ``simulator.py``).

The SUNDIALS CVODES/IDAS integrators of the reference are replaced, as in
the JAX package, by the adaptive step-doubling Radau IIA integrator
(``integration_tool`` 'radau', 'cvodes' or 'idas'), the fixed-substep Radau
integrator (``adaptive=False``) or RK4 (any other tool on an ODE), all from
``ops/integrators.py``; a discrete model's algebraic states come from a
Newton root find.  The integration runs on the device and in the dtype of
``resolve_device``/``resolve_dtype`` (read at ``setup()``); ``make_step``
takes and returns numpy.

``make_step`` logs as the reference does: the current x, u, the previous z
and aux, and the measurement at the next state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ._config import resolve_device, resolve_dtype
from .model._iteratedvariables import IteratedVariables
from .tools import NumStruct, FieldAccessor
from .tools import profiler
from .data import Data
from .ops.integrators import (make_adaptive_dae_integrator,
                              make_dae_integrator, make_ode_integrator,
                              newton_rootfind)


@dataclass
class SimulatorSettings:
    """``abstol/reltol`` are honored by the default adaptive Radau IIA
    integrator (the reference runs CVODES/IDAS at 1e-10); ``adaptive=False``
    takes ``substeps`` fixed Radau steps per ``t_step`` instead."""
    t_step: float | None = None
    abstol: float = 1e-10
    reltol: float = 1e-10
    integration_tool: str = "radau"   # 'cvodes'/'idas' accepted as aliases
    adaptive: bool = True             # error-controlled step adaptation
    substeps: int = 4                 # fixed mode: substeps per t_step;
                                      # adaptive mode: initial substeps
    collocation_deg: int = 3          # Radau IIA stages (order 2*deg-1)

    def check_for_mandatory_settings(self):
        assert self.t_step is not None, "t_step must be set."


class Simulator(IteratedVariables):
    """Forward-simulates the model one ``t_step`` per ``make_step`` call."""

    def __init__(self, model):
        assert model.flags["setup"], "Model must be setup before Simulator."
        self._init_iterated_variables(model)
        self.settings = SimulatorSettings()
        self.data = Data(model)
        self.flags = {"setup": False, "set_tvp_fun": False,
                      "set_p_fun": False, "first_step": True}
        self._x_scaling = NumStruct(model.spec("_x"), 1.0)
        self._z_scaling = NumStruct(model.spec("_z"), 1.0)
        self.tvp_fun = None
        self.p_fun = None

    # -------------------------------------------------------------- scaling
    @property
    def scaling(self):
        def get(key):
            tgt = {"_x": self._x_scaling, "_z": self._z_scaling}[key[0]]
            return tgt[key[1:]] if len(key) > 1 else tgt

        def set_(key, value):
            tgt = {"_x": self._x_scaling, "_z": self._z_scaling}[key[0]]
            if len(key) > 1:
                tgt[key[1:]] = value
            else:
                tgt.master = value
        return FieldAccessor(get, set_)

    # ----------------------------------------------------------- templating
    def set_param(self, **kwargs):
        for k, v in kwargs.items():
            if k == "integration_tool":
                v = {"cvodes": "radau", "idas": "radau"}.get(v, v)
            if hasattr(self.settings, k):
                setattr(self.settings, k, v)

    def get_tvp_template(self):
        return NumStruct(self.model.spec("_tvp"))

    def set_tvp_fun(self, tvp_fun):
        self.tvp_fun = tvp_fun
        self.flags["set_tvp_fun"] = True

    def get_p_template(self):
        return NumStruct(self.model.spec("_p"))

    def set_p_fun(self, p_fun):
        self.p_fun = p_fun
        self.flags["set_p_fun"] = True

    # ---------------------------------------------------------------- setup
    def setup(self):
        self.settings.check_for_mandatory_settings()
        model = self.model
        self._device = resolve_device()
        self._dtype = resolve_dtype()
        if self.tvp_fun is None:
            tmpl = self.get_tvp_template()
            self.tvp_fun = lambda t: tmpl
        if self.p_fun is None:
            tmpl = self.get_p_template()
            self.p_fun = lambda t: tmpl

        # args = (u, tvp, p, w)
        def f(x, z, args):
            u, tvp, p, w = args
            return model._rhs_fun(x, u, z, tvp, p, w)

        def g(x, z, args):
            u, tvp, p, w = args
            return model._alg_fun(x, u, z, tvp, p, w)

        s = self.settings
        self._stepper = None
        if model.model_type == "continuous":
            if model.n_z > 0 or s.integration_tool in ("radau", "cvodes",
                                                       "idas"):
                if s.adaptive:
                    stepper = make_adaptive_dae_integrator(
                        f, g, n_z=model.n_z, deg=s.collocation_deg,
                        abstol=s.abstol, reltol=s.reltol,
                        init_substeps=s.substeps)
                    self._stepper = stepper
                else:
                    stepper = make_dae_integrator(
                        f, g, n_z=model.n_z, substeps=s.substeps,
                        deg=s.collocation_deg)
            else:
                ode = make_ode_integrator(
                    lambda x, args: f(x, x.new_zeros((0,)), args),
                    method="rk4", substeps=max(s.substeps, 10))

                def stepper(x, z, args, h):
                    return ode(x, args, h), z

            def _sim(x0, z0, u, tvp, p, w, h):
                return stepper(x0, z0, (u, tvp, p, w), h)
        else:
            def _sim(x0, z0, u, tvp, p, w, h):
                args = (u, tvp, p, w)
                if model.n_z > 0:
                    z0 = newton_rootfind(lambda z, a: g(x0, z, a), z0, args)
                return f(x0, z0, args), z0

        self._sim = _sim
        self.flags["setup"] = True
        return self

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    @staticmethod
    def _host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    @property
    def adaptive_steps(self):
        """Steps (accepted and rejected) the adaptive integrator took in the
        last ``make_step``; None on the other routes."""
        return None if self._stepper is None else self._stepper.last_steps

    def reset_history(self):
        """Clear logged data and reset time (reference API)."""
        self._t0 = np.zeros(1)
        self.data.init_storage()

    def set_initial_guess(self):
        """Set the z initial guess from z0."""
        self._z_guess = self._z0.data.copy()

    def init_algebraic_variables(self):
        """Solve the algebraic equations for a consistent z0 by Newton."""
        model = self.model
        T = self._tensor

        def num(v):
            return v.data if hasattr(v, "data") else v
        u = T(self._u0.data)
        tvp = T(num(self.tvp_fun(self._t0)))
        p = T(num(self.p_fun(self._t0)))
        w = T(np.zeros(model.n_w))
        x = T(self._x0.data)

        def galg(z, args):
            return model._alg_fun(x, u, z, tvp, p, w)

        z = newton_rootfind(galg, T(self._z0.data), None)
        self._z0.data[:] = self._host(z)
        self.set_initial_guess()
        return self._z0.data.reshape(-1, 1)

    # ------------------------------------------------------------ runtime --
    def _num(self, v, spec_name):
        """Accept NumStruct / array / scalar and return a flat numpy vector."""
        if isinstance(v, NumStruct):
            return v.data
        return np.asarray(v, dtype=float).reshape(-1)

    def simulate(self):
        """One raw integration step using the current internal values."""
        with profiler.annotate("dompc_tpu_torch.Simulator.simulate"):
            x, z = self._sim(*self._sim_args)
        return self._host(x), self._host(z)

    def make_step(self, u0=None, v0=None, w0=None) -> np.ndarray:
        assert self.flags["setup"], \
            "Simulator is not setup. Call setup() first."
        model = self.model
        T = self._tensor
        if u0 is None:
            assert model.n_u == 0, "No input u0 provided."
            u0 = np.zeros(0)
        u0 = self._num(u0, "_u")
        w0 = np.zeros(model.n_w) if w0 is None else self._num(w0, "_w")
        v0 = np.zeros(model.n_v) if v0 is None else self._num(v0, "_v")
        tvp0 = self._num(self.tvp_fun(self._t0), "_tvp") if model.n_tvp \
            else np.zeros(0)
        p0 = self._num(self.p_fun(self._t0), "_p") if model.n_p \
            else np.zeros(0)

        x0 = self._x0.data.copy()
        z0_prev = getattr(self, "_z_guess", self._z0.data).copy()

        aux0 = self._host(model._aux_expression_fun(
            T(x0), T(u0), T(z0_prev), T(tvp0), T(p0)))

        self._sim_args = (T(x0 / self._x_scaling.data),
                          T(z0_prev / self._z_scaling.data if model.n_z
                            else z0_prev),
                          T(u0), T(tvp0), T(p0), T(w0), self.settings.t_step)
        x_next_scaled, z_next_scaled = self.simulate()
        x_next = x_next_scaled * self._x_scaling.data
        z_next = (z_next_scaled * self._z_scaling.data
                  if model.n_z else z_next_scaled)

        y_next = self._host(model._meas_fun(
            T(x_next), T(u0), T(z_next), T(tvp0), T(p0), T(v0)))

        self.data.update(_x=x0)
        self.data.update(_u=u0)
        self.data.update(_z=z0_prev)
        self.data.update(_tvp=tvp0)
        self.data.update(_p=p0)
        self.data.update(_y=y_next)
        self.data.update(_aux=aux0)
        self.data.update(_time=self._t0)

        self._x0.data[:] = x_next
        self._z0.data[:] = z_next
        self._z_guess = z_next.copy()
        self._u0.data[:] = u0
        self._t0 = self._t0 + self.settings.t_step
        self.flags["first_step"] = False
        return y_next.reshape(-1, 1)
