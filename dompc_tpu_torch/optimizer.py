"""Shared MPC/MHE optimization machinery (PyTorch port).

Counterpart of the JAX package's ``optimizer.py``:

* bounds & scaling structures with power indexing
* soft/hard nonlinear constraints with slack variables
* tvp/p template plumbing
* the orthogonal-collocation stage residual, built once as a tensor
  function and ``torch.func.vmap``-ed over all (stage, scenario, branch)
  instances
* scenario-tree index arrays, in numpy at setup time.
"""
from __future__ import annotations

import numpy as np
import torch

from .tools import NumStruct, StructSpec, FieldAccessor
from .ops.collocation import lagrange_matrices
from . import sym as casym


def const_cache(arr):
    """``ref -> arr`` as a tensor of ``ref``'s dtype and device, made once
    per (dtype, device): closures evaluated inside ``torch.func``
    transforms call this on every evaluation, and a host-to-device copy
    each time would dominate on the card.  The copy is made outside any
    transform (``sym.plain_tensor``), so a first call inside one is safe."""
    arr = np.asarray(arr, dtype=float)
    cache = {}

    def get(ref):
        key = (ref.dtype, ref.device)
        out = cache.get(key)
        if out is None:
            out = cache[key] = casym.plain_tensor(
                lambda: torch.as_tensor(arr, dtype=ref.dtype,
                                        device=ref.device))
        return out
    return get


# ---------------------------------------------------------------------------
# scenario tree (reference: optimizer.py:998-1048, same combinatorics)
# ---------------------------------------------------------------------------

def build_scenario_tree(n_combinations: int, n_horizon: int, n_robust: int):
    nk = n_horizon
    n_branches = [n_combinations if k < n_robust else 1 for k in range(nk)]
    n_scenarios = [n_combinations ** min(k, n_robust) for k in range(nk + 1)]
    n_max = n_scenarios[-1]
    child_scenario = -np.ones((nk, n_max, n_branches[0] if n_branches else 1),
                              dtype=int)
    parent_scenario = -np.ones((nk + 1, n_max), dtype=int)
    branch_offset = -np.ones((nk, n_max), dtype=int)
    structure_scenario = np.zeros((nk + 1, n_max), dtype=int)
    for k in range(nk):
        counter = 0
        for s in range(n_scenarios[k]):
            for b in range(n_branches[k]):
                child_scenario[k][s][b] = counter
                structure_scenario[k][counter] = s
                structure_scenario[k + 1][counter] = s
                parent_scenario[k + 1][counter] = s
                counter += 1
            if n_robust == 0 or k < n_robust:
                branch_offset[k][s] = 0
            else:
                branch_offset[k][s] = s % (n_branches[0] if n_branches else 1)
    return {
        "n_branches": n_branches,
        "n_scenarios": n_scenarios,
        "child_scenario": child_scenario,
        "parent_scenario": parent_scenario,
        "branch_offset": branch_offset,
        "structure_scenario": structure_scenario,
    }


# ---------------------------------------------------------------------------
# flat decision-vector layout
# ---------------------------------------------------------------------------

class OCPLayout:
    """Stage-major flat layout of the scaled decision vector.

    Entry keys: ('x_node', k, s), ('x_coll', k, c), ('z', k, c),
    ('u', k, s), ('eps', k, s).  Stage-major ordering keeps the KKT system
    block-tridiagonal in the stage index."""

    def __init__(self):
        self.offsets: dict = {}
        self.sizes: dict = {}
        self.size = 0
        self.stage_of: dict = {}

    def add(self, key, size, stage):
        assert key not in self.offsets
        self.offsets[key] = self.size
        self.sizes[key] = size
        self.stage_of[key] = stage
        self.size += size

    def sl(self, key):
        o = self.offsets[key]
        return slice(o, o + self.sizes[key])

    def idx(self, key):
        o = self.offsets[key]
        return np.arange(o, o + self.sizes[key])

    def stage_ranges(self, n_stages):
        """Return [(start, end)] covering each stage group (entries must be
        added stage-sorted)."""
        ranges = []
        for k in range(n_stages):
            idxs = [self.offsets[key] for key in self.offsets
                    if self.stage_of[key] == k]
            if not idxs:
                ranges.append((0, 0))
                continue
            start = min(idxs)
            end = max(self.offsets[key] + self.sizes[key]
                      for key in self.offsets if self.stage_of[key] == k)
            ranges.append((start, end))
        return ranges


# ---------------------------------------------------------------------------
# collocation stage residual
# ---------------------------------------------------------------------------

def make_stage_residual(model, settings, x_scaling, z_scaling, u_scaling,
                        p_scaling=None):
    """Build ``stage_g(xk0, coll, u, z, tvp, p, w) -> residuals``: algebraic
    equations at every collocation point, Lagrange-derivative collocation
    equations, and per-finite-element continuity.  All inputs scaled; rhs
    evaluated unscaled then divided by x-scaling.  Constants take the dtype
    and device of ``xk0``.

    Returns (stage_g, n_coll).  For discrete models n_coll == 0 and
    stage_g returns (alg, x_next).
    """
    n_x, n_z = model.n_x, model.n_z
    xs = const_cache(x_scaling)
    zs = const_cache(z_scaling if n_z else np.ones(0))
    us = const_cache(u_scaling if model.n_u else np.ones(0))
    ps = const_cache(p_scaling if p_scaling is not None
                     else np.ones(model.n_p))

    def rhs_scaled(x, u, z, tvp, p, w):
        f = model._rhs_fun(x * xs(x), u * us(x), z * zs(x), tvp,
                           p * ps(x), w)
        return f / xs(x)

    def alg_fn(x, u, z, tvp, p, w):
        return model._alg_fun(x * xs(x), u * us(x), z * zs(x), tvp,
                              p * ps(x), w)

    if model.model_type == "discrete":
        def stage_g(xk0, coll, u, z, tvp, p, w):
            alg = alg_fn(xk0, u, z, tvp, p, w)
            x_next = rhs_scaled(xk0, u, z, tvp, p, w)
            return alg, x_next
        return stage_g, 0

    deg = settings.collocation_deg
    ni = settings.collocation_ni
    assert settings.state_discretization == "collocation", \
        "continuous models use collocation discretization"
    tau, C, D = lagrange_matrices(deg, settings.collocation_type)
    h = settings.t_step / ni
    n_coll = ni * (deg + 1)

    def stage_g(xk0, coll, u, z, tvp, p, w):
        # coll: (n_coll*n_x,) in reference ik order; z: (n_coll*n_z,)
        X = coll.reshape(n_coll, n_x)
        Z = z.reshape(n_coll, n_z) if n_z else None

        def Xij(i, j):
            if i == 0 and j == 0:
                return xk0
            # ik order: (0,1)..(0,deg),(1,0)..(1,deg),...,xkf(last)
            flat = (j - 1) if i == 0 else (deg + (i - 1) * (deg + 1) + j)
            return X[flat]

        def Zij(i, j):
            if Z is None:
                return xk0[:0]
            return Z[i * (deg + 1) + j]

        res = []
        for i in range(ni):
            if n_z:
                res.append(alg_fn(Xij(i, 0), u, Zij(i, 0), tvp, p, w))
            for j in range(1, deg + 1):
                xp = sum(float(C[r, j]) * Xij(i, r) for r in range(deg + 1))
                fj = rhs_scaled(Xij(i, j), u, Zij(i, j), tvp, p, w)
                res.append(h * fj - xp)
                if n_z:
                    res.append(alg_fn(Xij(i, j), u, Zij(i, j), tvp, p, w))
            xf = sum(float(D[r]) * Xij(i, r) for r in range(deg + 1))
            x_next = Xij(i + 1, 0) if i + 1 < ni else X[n_coll - 1]
            res.append(x_next - xf)
        return torch.cat(res)

    return stage_g, n_coll


# ---------------------------------------------------------------------------
# Optimizer base: bounds, scaling, nl_cons, tvp/p plumbing
# ---------------------------------------------------------------------------

class Optimizer:
    """Base class for MPC and MHE (reference: optimizer.py:34)."""

    def _init_optimizer(self):
        model = self.model
        self._x_lb = NumStruct(model.spec("_x"), -np.inf)
        self._x_ub = NumStruct(model.spec("_x"), np.inf)
        self._u_lb = NumStruct(model.spec("_u"), -np.inf)
        self._u_ub = NumStruct(model.spec("_u"), np.inf)
        self._z_lb = NumStruct(model.spec("_z"), -np.inf)
        self._z_ub = NumStruct(model.spec("_z"), np.inf)
        self._x_terminal_lb = NumStruct(model.spec("_x"), -np.inf)
        self._x_terminal_ub = NumStruct(model.spec("_x"), np.inf)
        self._x_scaling = NumStruct(model.spec("_x"), 1.0)
        self._u_scaling = NumStruct(model.spec("_u"), 1.0)
        self._z_scaling = NumStruct(model.spec("_z"), 1.0)
        self._p_scaling = NumStruct(model.spec("_p"), 1.0)

        self.nl_cons_list: list[dict] = []
        self.slack_vars_list: list[dict] = []
        self.tvp_fun = None
        self.p_fun = None
        self.solver_stats: dict = {}

    # -------------------------------------------------- solution struct view --
    @property
    def opt_x_num(self):
        """Flat scaled solution vector with the reference's struct power
        indexing grafted on (see tools/_optxview.py)."""
        return self._opt_x_num_arr

    @opt_x_num.setter
    def opt_x_num(self, arr):
        from .tools._optxview import wrap_opt_x
        self._opt_x_num_arr = wrap_opt_x(
            arr, getattr(self, "_optx_resolver", None))

    @property
    def opt_x_num_unscaled(self):
        """Physical-units twin of :attr:`opt_x_num`."""
        return self._opt_x_num_unscaled_arr

    @opt_x_num_unscaled.setter
    def opt_x_num_unscaled(self, arr):
        from .tools._optxview import wrap_opt_x
        self._opt_x_num_unscaled_arr = wrap_opt_x(
            arr, getattr(self, "_optx_resolver", None))

    # ------------------------------------------------------------- bounds --
    _BOUND_MAP = {
        ("lower", "_x"): "_x_lb", ("upper", "_x"): "_x_ub",
        ("lower", "_u"): "_u_lb", ("upper", "_u"): "_u_ub",
        ("lower", "_z"): "_z_lb", ("upper", "_z"): "_z_ub",
    }

    @property
    def bounds(self):
        """``mpc.bounds['lower','_x','name'] = value``
        (reference: optimizer.py:268)."""
        def get(key):
            tgt = getattr(self, self._BOUND_MAP[(key[0], key[1])])
            return tgt[key[2:]] if len(key) > 2 else tgt

        def set_(key, value):
            tgt = getattr(self, self._BOUND_MAP[(key[0], key[1])])
            if len(key) > 2:
                tgt[key[2:]] = value
            else:
                tgt.master = value
        return FieldAccessor(get, set_)

    @property
    def terminal_bounds(self):
        """Terminal state bounds (reference: controller/_mpc.py:407)."""
        def get(key):
            tgt = self._x_terminal_lb if key[0] == "lower" \
                else self._x_terminal_ub
            return tgt[key[2:]] if len(key) > 2 else tgt

        def set_(key, value):
            tgt = self._x_terminal_lb if key[0] == "lower" \
                else self._x_terminal_ub
            if len(key) > 2:
                tgt[key[2:]] = value
            else:
                tgt.master = value
        return FieldAccessor(get, set_)

    _SCALING_MAP = {"_x": "_x_scaling", "_u": "_u_scaling",
                    "_z": "_z_scaling", "_p": "_p_scaling"}

    @property
    def scaling(self):
        """``mpc.scaling['_x','T_R'] = 100`` (reference: optimizer.py:356).
        MHE additionally accepts ``'_p_est'`` (reference: optimizer.py:404)."""
        def get(key):
            tgt = getattr(self, self._SCALING_MAP[key[0]])
            return tgt[key[1:]] if len(key) > 1 else tgt

        def set_(key, value):
            tgt = getattr(self, self._SCALING_MAP[key[0]])
            if len(key) > 1:
                tgt[key[1:]] = value
            else:
                tgt.master = value
        return FieldAccessor(get, set_)

    # ------------------------------------------------------------ nl_cons --
    def set_nl_cons(self, expr_name, expr, ub=np.inf, soft_constraint=False,
                    penalty_term_cons=1, maximum_violation=np.inf):
        """m(x,u,z,tvp,p) <= ub, optionally softened by a slack
        (reference: optimizer.py:483-541)."""
        assert not self.flags["setup"], "Cannot call set_nl_cons after setup."
        expr = casym.to_sym(expr)
        shape = self.model._expr_shape(
            expr, extra_specs=getattr(self, "_nl_cons_extra_specs", None))
        if soft_constraint:
            self.slack_vars_list.append({
                "slack_name": expr_name, "shape": shape,
                "ub": maximum_violation, "penalty": penalty_term_cons})
        self.nl_cons_list.append({
            "expr_name": expr_name, "expr": expr, "ub": ub, "shape": shape})
        return expr

    def _setup_nl_cons(self):
        """Build eps spec, the stacked nl_cons function and its upper bound
        (reference: optimizer.py:543-585).  The emitted function returns
        m(x,u,z,tvp,p) - eps - ub  (so feasibility is <= 0)."""
        model = self.model
        eps_spec = StructSpec(
            [(s["slack_name"], s["shape"]) for s in self.slack_vars_list])
        self._eps_spec = eps_spec
        self.n_eps_vars = eps_spec.size
        self._eps_lb = eps_spec.zeros()
        self._eps_ub = eps_spec.full(np.inf)
        eps_penalty = eps_spec.zeros()
        for s in self.slack_vars_list:
            self._eps_ub[eps_spec.slice(s["slack_name"])] = s["ub"]
            eps_penalty[eps_spec.slice(s["slack_name"])] = s["penalty"]
        self._eps_penalty = eps_penalty

        nl_list = self.nl_cons_list
        slack_names = {s["slack_name"] for s in self.slack_vars_list}
        ub_parts = [np.full(int(np.prod(c["shape"])), float(np.asarray(
            c["ub"]).reshape(-1)[0]) if np.size(c["ub"]) == 1 else 0.0)
            for c in nl_list]
        for part, c in zip(ub_parts, nl_list):
            if np.size(c["ub"]) > 1:
                part[:] = np.asarray(c["ub"], dtype=float).reshape(-1)
        self._nl_cons_ub = (np.concatenate(ub_parts) if ub_parts
                            else np.zeros(0))
        self.n_nl_cons = self._nl_cons_ub.shape[0]
        nl_ub = const_cache(self._nl_cons_ub)

        def nl_cons_fun(x, u, z, tvp, p, eps):
            """All inputs unscaled flat vectors; returns residual <= 0."""
            env = model._env(x, u, z, tvp, p)
            parts = []
            for c in nl_list:
                size = int(np.prod(c["shape"]))
                val = model._flat(c["expr"](env), size, x)
                if c["expr_name"] in slack_names:
                    val = val - eps[eps_spec.slice(c["expr_name"])]
                parts.append(val)
            out = torch.cat(parts) if parts \
                else torch.zeros((0,), dtype=x.dtype, device=x.device)
            return out - nl_ub(x)

        self._nl_cons_fun = nl_cons_fun
        pen = const_cache(eps_penalty)

        def epsterm_fun(eps):
            return torch.dot(pen(eps), eps)
        self._epsterm_fun = epsterm_fun

    def compile_nlp(self, overwrite=False, cname=None, libname=None,
                    compiler_command=None):
        """API-compatibility no-op for the reference's experimental gcc
        codegen (do_mpc/optimizer.py:678-729).  The port's only compiled
        code is its band kernels, which ``nvcc`` builds into ``build/`` at
        their first launch and reuses from there, keyed by a hash of their
        sources and flags: the role of the reference's cached ``.so``."""

    # --------------------------------------------------------------- tvp/p --
    def get_tvp_template(self):
        """Time-indexed tvp template over (n_horizon+1) steps
        (reference: optimizer.py:588)."""
        return _TVPTemplate(self.model.spec("_tvp"), self._tvp_template_len())

    def set_tvp_fun(self, tvp_fun):
        self.tvp_fun = tvp_fun
        self.flags["set_tvp_fun"] = True

    def _tvp_template_len(self):
        return self.settings.n_horizon + 1

    def _eval_tvp(self, t0):
        """Evaluate user tvp_fun -> (n_steps, n_tvp) numpy array."""
        n = self._tvp_template_len()
        if self.model.n_tvp == 0 or self.tvp_fun is None:
            return np.zeros((n, 0))
        out = self.tvp_fun(float(np.asarray(t0).reshape(-1)[0]))
        if isinstance(out, _TVPTemplate):
            return out.array()
        arr = np.asarray(out, dtype=float)
        if arr.ndim == 1:
            arr = np.tile(arr.reshape(1, -1), (n, 1))
        return arr.reshape(n, self.model.n_tvp)


class _TVPTemplate:
    """Time-indexed tvp template: ``tmpl['_tvp', k, 'name'] = value``
    mirroring the reference's struct template API."""

    def __init__(self, tvp_spec, n):
        self._data = np.zeros((n, tvp_spec.size))
        self._spec = tvp_spec
        self.n = n

    def __setitem__(self, key, value):
        if isinstance(key, tuple) and key[0] == "_tvp":
            key = key[1:]
        k = key[0] if isinstance(key, tuple) else key
        if isinstance(key, tuple) and len(key) > 1:
            name = key[1]
            sl = self._spec.slice(name)
            if isinstance(k, slice):
                self._data[k, sl] = np.asarray(value, dtype=float).reshape(-1)
            else:
                self._data[int(k), sl] = np.asarray(
                    value, dtype=float).reshape(-1)
        else:
            self._data[k if isinstance(k, slice) else int(k), :] = \
                np.asarray(value, dtype=float).reshape(-1)

    def __getitem__(self, key):
        if isinstance(key, tuple) and key[0] == "_tvp":
            key = key[1:]
        if isinstance(key, tuple) and len(key) > 1:
            return self._data[int(key[0]), self._spec.slice(key[1])]
        return self._data[key]

    def array(self):
        return self._data
