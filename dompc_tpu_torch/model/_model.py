"""Declarative dynamic-system model (PyTorch port).

Same API as the JAX package's ``model.Model``: variables are registered by
name, right-hand sides / algebraic equations / measurements are
:class:`~dompc_tpu_torch.sym.Sym` expressions, and ``setup()`` freezes the
model and builds flat functions over concatenated vectors plus
``torch.func.jacfwd`` Jacobians.  The flat functions take tensors of any
dtype and device; constants follow the dtype and device of ``x``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import sym as casym
from ..sym import Sym, META
from ..tools import StructSpec

# canonical variable groups, in the order the reference uses
VAR_TYPES = ("_x", "_u", "_z", "_p", "_tvp", "_w", "_v")

_ALIASES = {
    "_x": "_x", "states": "_x", "x": "_x",
    "_u": "_u", "inputs": "_u", "u": "_u",
    "_z": "_z", "algebraic": "_z", "z": "_z",
    "_p": "_p", "parameter": "_p", "p": "_p",
    "_tvp": "_tvp", "timevarying_parameter": "_tvp", "tvp": "_tvp",
}


class SymView:
    """Read accessor over one variable group: ``model.x['C_a']`` -> Sym."""

    def __init__(self, var_type: str, spec: StructSpec):
        self._var_type = var_type
        self._spec = spec

    def __getitem__(self, key):
        if isinstance(key, tuple):
            name, *idx = key
            base = casym.var(self._var_type, name)
            return base[tuple(idx)]
        if key not in self._spec:
            raise KeyError(f"{key!r} not in {self._var_type}: {self._spec.names}")
        return casym.var(self._var_type, key)

    def keys(self):
        return list(self._spec.names)

    @property
    def cat(self) -> Sym:
        spec = self._spec
        return casym.pack_var(self._var_type, spec.names,
                              [spec.shapes[n] for n in spec.names])

    def __repr__(self):
        return f"SymView({self._var_type}: {self._spec.names})"


def _as_tensor(val, ref):
    """Python scalar / numpy value -> tensor of ``ref``'s dtype and device."""
    if isinstance(val, torch.Tensor):
        return val
    return torch.as_tensor(np.asarray(val, dtype=float), dtype=ref.dtype,
                           device=ref.device)


class Model:
    """Declarative ODE/DAE/discrete model container."""

    def __init__(self, model_type: str, symvar_type: str = "SX"):
        assert model_type in ("continuous", "discrete"), \
            f"model_type must be 'continuous' or 'discrete', got {model_type!r}"
        # symvar_type accepted for API compatibility with the reference; ignored.
        self.model_type = model_type
        self.symvar_type = symvar_type
        self.flags = {"setup": False}

        self._specs = {vt: StructSpec() for vt in VAR_TYPES}
        self._specs["_y"] = StructSpec()
        self._specs["_aux"] = StructSpec()

        self._rhs: dict[str, Sym] = {}
        self._rhs_has_noise: dict[str, bool] = {}
        self._alg_list: list[tuple[str, Sym]] = []
        self._meas: dict[str, Sym] = {}
        self._meas_has_noise: dict[str, bool] = {}
        self._aux_exprs: dict[str, Sym] = {}
        self.integer_u: list[str] = []

    # ------------------------------------------------------------------ API
    def set_variable(self, var_type: str, var_name: str, shape=(1, 1),
                     integer: bool = False,
                     input_type_integer: bool = False) -> Sym:
        """Register a new variable (reference: model/_model.py:537)."""
        assert not self.flags["setup"], "Cannot set_variable after setup()."
        vt = _ALIASES.get(var_type)
        if vt is None:
            raise ValueError(f"unknown var_type {var_type!r}")
        self._specs[vt].add(var_name, shape)
        if vt == "_u" and (integer or input_type_integer):
            self.integer_u.append(var_name)
        return casym.var(vt, var_name)

    def set_expression(self, expr_name: str, expr) -> Sym:
        """Register a monitored auxiliary expression (reference: :623)."""
        assert not self.flags["setup"], "Cannot set_expression after setup()."
        expr = casym.to_sym(expr)
        self._aux_exprs[expr_name] = expr
        return expr

    def set_meas(self, meas_name: str, expr, meas_noise: bool = True) -> Sym:
        """Register a measurement, optionally with additive noise v
        (reference: :670)."""
        assert not self.flags["setup"], "Cannot set_meas after setup()."
        expr = casym.to_sym(expr)
        self._meas[meas_name] = expr
        self._meas_has_noise[meas_name] = bool(meas_noise)
        return expr

    def set_rhs(self, var_name: str, expr, process_noise: bool = False):
        """Set dx/dt (continuous) or x_next (discrete) for a state
        (reference: :749)."""
        assert not self.flags["setup"], "Cannot set_rhs after setup()."
        assert var_name in self._specs["_x"], \
            f"set_rhs: {var_name!r} is not a declared state"
        self._rhs[var_name] = casym.to_sym(expr)
        self._rhs_has_noise[var_name] = bool(process_noise)

    def set_alg(self, expr_name: str, expr):
        """Add an algebraic equation expr == 0 (reference: :811)."""
        assert not self.flags["setup"], "Cannot set_alg after setup()."
        self._alg_list.append((expr_name, casym.to_sym(expr)))

    # ------------------------------------------------------------ accessors
    @property
    def x(self): return SymView("_x", self._specs["_x"])
    @property
    def u(self): return SymView("_u", self._specs["_u"])
    @property
    def z(self): return SymView("_z", self._specs["_z"])
    @property
    def p(self): return SymView("_p", self._specs["_p"])
    @property
    def tvp(self): return SymView("_tvp", self._specs["_tvp"])
    @property
    def w(self): return SymView("_w", self._specs["_w"])
    @property
    def v(self): return SymView("_v", self._specs["_v"])

    @property
    def aux(self):
        exprs = self._aux_exprs

        class _AuxView(SymView):
            def __getitem__(self, key):  # aux expressions are inlined
                return exprs[key]
        return _AuxView("_aux", self._specs["_aux"])

    def spec(self, var_type: str) -> StructSpec:
        return self._specs[var_type]

    def __getitem__(self, key):
        if isinstance(key, tuple):
            return [getattr(self, _ALIASES[k].lstrip("_")) for k in key]
        return getattr(self, _ALIASES[key].lstrip("_"))

    # ------------------------------------------------------------- internal
    def _env(self, x, u, z, tvp, p, w=None, v=None):
        """Name -> tensor views of the flat inputs.  ``x`` fixes the dtype
        and device that constants of the expressions take."""
        env = {
            "_x": self._specs["_x"].unpack(x, xp=torch),
            "_u": self._specs["_u"].unpack(u, xp=torch),
            "_z": self._specs["_z"].unpack(z, xp=torch),
            "_tvp": self._specs["_tvp"].unpack(tvp, xp=torch),
            "_p": self._specs["_p"].unpack(p, xp=torch),
            META: (x.dtype, x.device),
        }
        if w is not None:
            env["_w"] = self._specs["_w"].unpack(w, xp=torch)
        if v is not None:
            env["_v"] = self._specs["_v"].unpack(v, xp=torch)
        return env

    @staticmethod
    def _flat(val, size, ref):
        val = _as_tensor(val, ref)
        if val.ndim > 1:
            val = val.T.reshape(-1)  # column-major like CasADi vectorization
        else:
            val = torch.reshape(val, (-1,))
        return torch.broadcast_to(val, (size,))

    # ---------------------------------------------------------------- setup
    def setup(self):
        """Freeze the model and build the flat functions
        (reference: :937-1051)."""
        assert not self.flags["setup"], "setup() already called."
        xs = self._specs["_x"]
        for name in xs.names:
            assert name in self._rhs, f"missing set_rhs for state {name!r}"

        for name in xs.names:
            if self._rhs_has_noise[name]:
                self._specs["_w"].add(name, xs.shapes[name])

        # default state feedback (reference: model/_model.py:942-955)
        if not self._meas:
            for name in xs.names:
                self._meas[name] = casym.var("_x", name)
                self._meas_has_noise[name] = True

        for mname, expr in self._meas.items():
            shape = self._expr_shape(expr)
            self._specs["_y"].add(mname, shape)
            if self._meas_has_noise[mname]:
                self._specs["_v"].add(mname, shape)

        for aname, expr in self._aux_exprs.items():
            self._specs["_aux"].add(aname, self._expr_shape(expr))

        self.n_x = self._specs["_x"].size
        self.n_u = self._specs["_u"].size
        self.n_z = self._specs["_z"].size
        self.n_p = self._specs["_p"].size
        self.n_tvp = self._specs["_tvp"].size
        self.n_w = self._specs["_w"].size
        self.n_v = self._specs["_v"].size
        self.n_y = self._specs["_y"].size

        n_alg = sum(int(np.prod(self._expr_shape(e))) for _, e in self._alg_list)
        assert n_alg == self.n_z, (
            f"Number of algebraic equations ({n_alg}) must match number of "
            f"algebraic variables n_z ({self.n_z}).")

        self._build_functions()
        self.flags["setup"] = True
        return self

    def _build_functions(self):
        """Build the flat rhs/alg/meas/aux functions and Jacobian oracles
        from the declarative expression dicts (also run on unpickle)."""
        specs = self._specs
        rhs, rhs_noise = self._rhs, self._rhs_has_noise
        alg_list = self._alg_list
        meas, meas_noise = self._meas, self._meas_has_noise
        aux_exprs = self._aux_exprs

        def _empty(x):
            return torch.zeros((0,), dtype=x.dtype, device=x.device)

        def _rhs_fun(x, u, z, tvp, p, w):
            env = self._env(x, u, z, tvp, p, w=w)
            parts = []
            for name in specs["_x"].names:
                size = specs["_x"].block_size(name)
                val = self._flat(rhs[name](env), size, x)
                if rhs_noise[name]:
                    val = val + self._flat(env["_w"][name], size, x)
                parts.append(val)
            return torch.cat(parts) if parts else _empty(x)

        def _alg_fun(x, u, z, tvp, p, w):
            env = self._env(x, u, z, tvp, p, w=w)
            parts = [torch.reshape(_as_tensor(e(env), x), (-1,))
                     for _, e in alg_list]
            return torch.cat(parts) if parts else _empty(x)

        def _meas_fun(x, u, z, tvp, p, v):
            env = self._env(x, u, z, tvp, p, v=v)
            parts = []
            for mname in specs["_y"].names:
                size = specs["_y"].block_size(mname)
                val = self._flat(meas[mname](env), size, x)
                if meas_noise[mname]:
                    val = val + self._flat(env["_v"][mname], size, x)
                parts.append(val)
            return torch.cat(parts) if parts else _empty(x)

        def _aux_expression_fun(x, u, z, tvp, p):
            env = self._env(x, u, z, tvp, p)
            parts = []
            for aname in specs["_aux"].names:
                size = specs["_aux"].block_size(aname)
                parts.append(self._flat(aux_exprs[aname](env), size, x))
            return torch.cat(parts) if parts else _empty(x)

        self._rhs_fun = _rhs_fun
        self._alg_fun = _alg_fun
        self._meas_fun = _meas_fun
        self._aux_expression_fun = _aux_expression_fun
        self.n_aux = specs["_aux"].size

        # Jacobian functions (reference builds A/B/C/D CasADi functions :1008)
        self._A_fun = torch.func.jacfwd(_rhs_fun, argnums=0)
        self._B_fun = torch.func.jacfwd(_rhs_fun, argnums=1)
        self._C_fun = torch.func.jacfwd(_meas_fun, argnums=0)
        self._D_fun = torch.func.jacfwd(_meas_fun, argnums=1)

    def _expr_shape(self, expr, extra_specs=None):
        """Shape of an expression, evaluated on ``meta`` tensors (shapes
        only, no arithmetic).  ``extra_specs``: optional {env_key:
        StructSpec} for non-model variables."""
        meta = (torch.float64, torch.device("meta"))

        def zeros(shape):
            return torch.zeros(shape, dtype=meta[0], device=meta[1])

        env = {vt: {n: zeros(self._env_shape(vt, n))
                    for n in self._specs[vt].names}
               for vt in VAR_TYPES}
        env[META] = meta
        if extra_specs:
            for key, spec in extra_specs.items():
                env[key] = {n: zeros(
                    (spec.shapes[n][0],) if spec.shapes[n][1] == 1
                    else spec.shapes[n]) for n in spec.names}
        out = expr(env)
        shp = tuple(out.shape) if isinstance(out, torch.Tensor) \
            else np.shape(out)
        if len(shp) == 0:
            return (1, 1)
        if len(shp) == 1:
            return (shp[0], 1)
        return shp

    def _env_shape(self, vt, name):
        shape = self._specs[vt].shapes[name]
        return (shape[0],) if shape[1] == 1 else shape

    def __getstate__(self):
        """Pickle the declarative state; the closures are rebuilt on
        unpickle.  A Sym wrapping a raw user closure raises."""
        state = self.__dict__.copy()
        for key in ("_rhs_fun", "_alg_fun", "_meas_fun",
                    "_aux_expression_fun", "_A_fun", "_B_fun", "_C_fun",
                    "_D_fun"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.flags.get("setup"):
            self._build_functions()

    # ------------------------------------------------------------ linearize
    def get_linear_system_matrices(self, xss=None, uss=None, zss=None,
                                   pss=None, tvpss=None):
        """Numeric A, B, C, D at an operating point, in float64 on the CPU
        (reference: :1090)."""
        assert self.flags["setup"], "Call setup() first."

        def vec(val, size):
            arr = np.zeros(size) if val is None \
                else np.asarray(val, dtype=float).reshape(-1)
            return torch.as_tensor(arr, dtype=torch.float64,
                                   device=torch.device("cpu"))

        x, u = vec(xss, self.n_x), vec(uss, self.n_u)
        z, p, tvp = vec(zss, self.n_z), vec(pss, self.n_p), \
            vec(tvpss, self.n_tvp)
        w, v = vec(None, self.n_w), vec(None, self.n_v)
        A = self._A_fun(x, u, z, tvp, p, w).numpy()
        B = self._B_fun(x, u, z, tvp, p, w).numpy()
        C = self._C_fun(x, u, z, tvp, p, v).numpy()
        D = self._D_fun(x, u, z, tvp, p, v).numpy()
        return A, B, C, D
