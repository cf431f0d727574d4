"""Nonlinear (economic, robust multi-stage) model-predictive controller
(PyTorch port).

Counterpart of the JAX package's ``controller/_mpc.py``: the same
collocation transcription, scenario tree, scaling, soft constraints and
cost weighting, assembled as tensor functions whose per-(stage, scenario,
branch) structure is gather-index arrays + ``torch.func.vmap``; all
derivatives are instance-local ``torch.func`` transforms scattered into the
global arrays.  The oracles and both structured KKT backends take a leading
batch axis (B problem instances; the oracles also take one instance's
vectors).  The NLP is solved by the batch-first
:mod:`dompc_tpu_torch.solver.ipm` with the condensed bordered-block-diagonal
KKT backend, whose chain sweep is a CUDA band kernel on the card;
``make_step`` solves a batch of one, ``parallel.make_batch_solver`` many.

Device and dtype are read from the environment at ``setup()``
(``DOMPC_TPU_PLATFORM=cpu`` for the CPU, else CUDA; ``DOMPC_TPU_X64=1`` for
float64, else float32).  ``make_step`` keeps the data-logging and
warm-start semantics of the JAX package.
"""
from __future__ import annotations

import itertools
import time as _time
import warnings

import numpy as np
import torch

from .._config import resolve_device, resolve_dtype
from ..model._iteratedvariables import IteratedVariables
from ..model._model import SymView
from ..optimizer import (Optimizer, OCPLayout, build_scenario_tree,
                         make_stage_residual)
from ..tools import NumStruct
from ..tools import _profiler as profiler
from ..tools._optxview import make_mpc_resolver
from ..data import MPCData
from ..solver.ipm import make_ipm_solver, ipm_settings_from
from ..solver.minlp import BranchAndBound
from ..solver.bbd import (BBDAssembler, CondensedAssembler, bbd_kkt_solve,
                          bbd_solve, band_backend, demote_by_usage,
                          scatter_sum_cols, ROOT)
from .. import sym as casym
from ._controllersettings import MPCSettings


class _PTemplate:
    """Numeric template over n_combinations parameter sets
    (reference: controller/_mpc.py:711-817)."""

    def __init__(self, p_spec, n_comb):
        self._spec = p_spec
        self.n_comb = n_comb
        self._data = np.zeros((n_comb, p_spec.size))

    def __setitem__(self, key, value):
        if isinstance(key, tuple) and key[0] == "_p":
            key = key[1:]
        if isinstance(key, str):
            self._data[:, self._spec.slice(key)] = np.asarray(
                value, dtype=float).reshape(1, -1)
            return
        if isinstance(key, tuple):
            k = key[0]
            if len(key) > 1:
                self._data[k, self._spec.slice(key[1])] = np.asarray(
                    value, dtype=float).reshape(-1)
            else:
                self._data[k, :] = np.asarray(value, dtype=float).reshape(-1)
        else:
            self._data[key, :] = np.asarray(value, dtype=float).reshape(-1)

    def __getitem__(self, key):
        if isinstance(key, tuple) and key[0] == "_p":
            key = key[1:]
        if isinstance(key, str):
            return self._data[:, self._spec.slice(key)]
        if isinstance(key, tuple) and len(key) > 1:
            return self._data[key[0], self._spec.slice(key[1])]
        return self._data[key]

    def array(self):
        return self._data


def _idx(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _any_batch(fn):
    """An oracle over a batch ((B, n), (B, n_p), ...) that also takes one
    instance's vectors, the JAX package's per-instance signature."""
    def wrapped(w, pvec, *rest):
        if w.ndim == 1:
            return fn(w[None], pvec[None], *[r[None] for r in rest])[0]
        return fn(w, pvec, *rest)
    return wrapped


class MPC(Optimizer, IteratedVariables):
    """Model predictive controller (reference: controller/_mpc.py:37)."""

    def __init__(self, model, settings: MPCSettings | None = None):
        assert model.flags["setup"], "Model must be setup before MPC."
        self._init_iterated_variables(model)
        self._init_optimizer()
        self.settings = settings or MPCSettings()
        self.data = MPCData(model)
        self.flags = {
            "setup": False, "set_objective": False, "set_rterm": False,
            "set_tvp_fun": False, "set_p_fun": False,
            "set_initial_guess": False, "initial_run": False,
        }
        self.rterm_factor = NumStruct(model.spec("_u"), 0.0)
        self._rterm_fun_sym = None
        self.n_combinations = 1
        self._lterm = None
        self._mterm = None
        self._last_sol = None

    # ------------------------------------------------------------- config --
    @property
    def u_prev(self):
        """Sym view of the previous input for custom rterm expressions."""
        return SymView("_u_prev", self.model.spec("_u"))

    def set_param(self, **kwargs):
        """Deprecated kwargs path (reference: _mpc.py:482-523)."""
        for k, v in kwargs.items():
            if hasattr(self.settings, k):
                setattr(self.settings, k, v)

    def set_objective(self, mterm=None, lterm=None):
        """Stage cost lterm(x,u,z,tvp,p) + terminal cost mterm(x,tvp,p)
        (reference: _mpc.py:525)."""
        assert not self.flags["setup"]
        self._mterm = casym.to_sym(mterm if mterm is not None else 0.0)
        self._lterm = casym.to_sym(lterm if lterm is not None else 0.0)
        self.flags["set_objective"] = True

    def set_rterm(self, rterm=None, **kwargs):
        """Input-rate penalty: quadratic factors (kwargs) or a custom
        expression using ``mpc.u_prev`` (reference: _mpc.py:593-677)."""
        assert not self.flags["setup"]
        if rterm is not None:
            self._rterm_fun_sym = casym.to_sym(rterm)
        for name, val in kwargs.items():
            self.rterm_factor[name] = val
        self.flags["set_rterm"] = True

    def get_p_template(self, n_combinations: int):
        self.n_combinations = n_combinations
        return _PTemplate(self.model.spec("_p"), n_combinations)

    def set_p_fun(self, p_fun):
        self.p_fun = p_fun
        self.flags["set_p_fun"] = True

    def set_uncertainty_values(self, **kwargs):
        """Cartesian product of per-parameter value lists; the first value
        of each list is nominal (reference: _mpc.py:819-881)."""
        spec = self.model.spec("_p")
        assert set(kwargs).issubset(set(spec.names)), (
            f"unknown parameter names {set(kwargs) - set(spec.names)}")
        values = []
        for name in spec.names:
            bs = spec.block_size(name)
            if name in kwargs:
                v = np.asarray(kwargs[name], dtype=float)
                v = v.reshape(-1, 1) if (v.ndim <= 1 and bs == 1) \
                    else v.reshape(-1, bs)
            else:
                v = np.zeros((1, bs))
            values.append([row for row in v])
        combos = np.array([np.concatenate(c)
                           for c in itertools.product(*values)])
        tmpl = self.get_p_template(combos.shape[0])
        tmpl._data[:, :] = combos
        self.set_p_fun(lambda t: tmpl)

    # -------------------------------------------------------------- setup --
    def _check_validity(self):
        """Reference: _mpc.py:883-933."""
        if not self.flags["set_objective"]:
            raise RuntimeError("Objective is undefined. Call set_objective().")
        if not self.flags["set_rterm"]:
            warnings.warn("rterm was not set and defaults to zero.")
        if not self.flags["set_tvp_fun"] and self.model.n_tvp > 0:
            raise RuntimeError("Model has tvp but set_tvp_fun() not called.")
        if not self.flags["set_p_fun"] and self.model.n_p > 0:
            raise RuntimeError("Model has p but no p_fun/uncertainty values.")
        for lbs, ubs in ((self._x_lb, self._x_ub), (self._u_lb, self._u_ub),
                         (self._z_lb, self._z_ub)):
            assert np.all(lbs.data <= ubs.data), "lower bound > upper bound"
        if self.settings.use_terminal_bounds:
            if np.all(self._x_terminal_ub.data == np.inf):
                self._x_terminal_ub.data[:] = self._x_ub.data
            if np.all(self._x_terminal_lb.data == -np.inf):
                self._x_terminal_lb.data[:] = self._x_lb.data
        if self.model.n_tvp == 0 and self.tvp_fun is None:
            self.set_tvp_fun(lambda t: np.zeros((0,)))
        if self.model.n_p == 0 and self.p_fun is None:
            tmpl = self.get_p_template(1)
            self.set_p_fun(lambda t: tmpl)

    def setup(self):
        self.prepare_nlp()
        self.create_nlp()
        return self

    def prepare_nlp(self):
        self._prepare_nlp()

    def create_nlp(self):
        self._create_solver()
        self._prepare_data()
        self.flags["setup"] = True

    def _tensor(self, a):
        """numpy -> tensor of the controller's dtype and device."""
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    # ---------------------------------------------------- NLP construction --
    def _prepare_nlp(self):
        self._device = resolve_device()
        self._dtype = resolve_dtype()
        st = self.settings
        st.check_for_mandatory_settings()
        model = self.model
        self._setup_nl_cons()
        self._check_validity()

        n_x, n_u, n_z = model.n_x, model.n_u, model.n_z
        n_tvp, n_p = model.n_tvp, model.n_p
        N = st.n_horizon
        n_comb = self.n_combinations

        stage_g, n_coll = make_stage_residual(
            model, st, self._x_scaling.data, self._z_scaling.data,
            self._u_scaling.data)
        self._stage_g = stage_g
        self.n_total_coll_points = n_coll
        n_coll_z = max(n_coll, 1)

        tree = build_scenario_tree(n_comb, N, st.n_robust)
        self.scenario_tree = tree
        nscen = tree["n_scenarios"]
        nbr = tree["n_branches"]
        child = tree["child_scenario"]
        parent = tree["parent_scenario"]
        boff = tree["branch_offset"]
        n_max = nscen[-1]
        n_eps_rep = 1 if st.nl_cons_single_slack else N
        nev = self.n_eps_vars

        def n_u_scen(k):
            return 1 if st.open_loop else nscen[k]

        # ----- layout (stage-major) -----
        L = OCPLayout()
        for k in range(N):
            for s in range(nscen[k]):
                L.add(("x_node", k, s), n_x, k)
            for su in range(n_u_scen(k)):
                L.add(("u", k, su), n_u, k)
            if k < n_eps_rep and nev:
                eps_scen = nscen[k] if n_eps_rep == N else n_max
                for s in range(eps_scen):
                    L.add(("eps", k, s), nev, k)
            for c in range(nscen[k + 1]):
                if n_coll:
                    L.add(("x_coll", k, c), n_coll * n_x, k)
                if n_z:
                    L.add(("z", k, c), n_coll_z * n_z, k)
        for s in range(nscen[N]):
            L.add(("x_node", N, s), n_x, N)
        self.layout = L
        self.n_opt_x = L.size

        # ----- scaling vector over w -----
        scal = np.ones(L.size)
        for key in L.offsets:
            kind = key[0]
            if kind == "x_node":
                scal[L.sl(key)] = self._x_scaling.data
            elif kind == "x_coll":
                scal[L.sl(key)] = np.tile(self._x_scaling.data, n_coll)
            elif kind == "z":
                scal[L.sl(key)] = np.tile(self._z_scaling.data, n_coll_z)
            elif kind == "u":
                scal[L.sl(key)] = self._u_scaling.data
        self.opt_x_scaling = scal

        # ----- bounds over w (reference _update_bounds, _mpc.py:1061-1095) --
        lb = np.full(L.size, -np.inf)
        ub = np.full(L.size, np.inf)
        xs, us, zs = (self._x_scaling.data, self._u_scaling.data,
                      self._z_scaling.data)
        for key in L.offsets:
            kind = key[0]
            if kind == "x_node":
                k = key[1]
                if 1 <= k <= N - 1:
                    lb[L.sl(key)] = self._x_lb.data / xs
                    ub[L.sl(key)] = self._x_ub.data / xs
                elif k == N:
                    lb[L.sl(key)] = self._x_terminal_lb.data / xs
                    ub[L.sl(key)] = self._x_terminal_ub.data / xs
            elif kind == "x_coll" and st.cons_check_colloc_points:
                # '_x',1:N covers the collocation blocks of intervals 0..N-2
                if key[1] <= N - 2:
                    lb[L.sl(key)] = np.tile(self._x_lb.data / xs, n_coll)
                    ub[L.sl(key)] = np.tile(self._x_ub.data / xs, n_coll)
            elif kind == "z":
                if st.cons_check_colloc_points:
                    lb[L.sl(key)] = np.tile(self._z_lb.data / zs, n_coll_z)
                    ub[L.sl(key)] = np.tile(self._z_ub.data / zs, n_coll_z)
                else:
                    o = L.offsets[key]
                    lb[o:o + n_z] = self._z_lb.data / zs
                    ub[o:o + n_z] = self._z_ub.data / zs
            elif kind == "u":
                lb[L.sl(key)] = self._u_lb.data / us
                ub[L.sl(key)] = self._u_ub.data / us
            elif kind == "eps":
                lb[L.sl(key)] = self._eps_lb
                ub[L.sl(key)] = self._eps_ub
        self._lb_opt_x = lb
        self._ub_opt_x = ub

        # ----- opt_p layout -----
        self._p_sl = {
            "x0": slice(0, n_x),
            "tvp": slice(n_x, n_x + (N + 1) * n_tvp),
            "p": slice(n_x + (N + 1) * n_tvp,
                       n_x + (N + 1) * n_tvp + n_comb * n_p),
            "u_prev": slice(n_x + (N + 1) * n_tvp + n_comb * n_p,
                            n_x + (N + 1) * n_tvp + n_comb * n_p + n_u),
        }
        self.n_opt_p = self._p_sl["u_prev"].stop

        # ----- instance table (k, s, b) in reference loop order -----
        inst = []
        for k in range(N):
            for s in range(nscen[k]):
                s_u = 0 if st.open_loop else s
                for b in range(nbr[k]):
                    inst.append(dict(k=k, s=s, b=b, c=child[k][s][b],
                                     s_u=s_u, p_idx=b + boff[k][s],
                                     k_eps=min(k, n_eps_rep - 1), eps_s=s))
        I = len(inst)
        self.n_instances = I
        self._instances = inst

        def idxmat(keys):
            return np.stack([L.idx(key) for key in keys])

        A_node = idxmat([("x_node", i["k"], i["s"]) for i in inst])
        A_node_next = idxmat([("x_node", i["k"] + 1, i["c"]) for i in inst])
        A_u = idxmat([("u", i["k"], i["s_u"]) for i in inst]) \
            if n_u else np.zeros((I, 0), int)
        A_uprev = np.stack([
            L.idx(("u", i["k"] - 1,
                   parent[i["k"]][i["s_u"]] if not st.open_loop else 0))
            if i["k"] > 0 else np.zeros(n_u, int) for i in inst]) \
            if n_u else np.zeros((I, 0), int)
        mask_k0 = np.array([i["k"] == 0 for i in inst])
        A_coll = idxmat([("x_coll", i["k"], i["c"]) for i in inst]) \
            if n_coll else np.zeros((I, 0), int)
        A_z_dyn = idxmat([("z", i["k"], i["c"]) for i in inst]) \
            if n_z else np.zeros((I, 0), int)
        A_z_cost = (A_z_dyn[:, -n_z:] if n_z else np.zeros((I, 0), int))
        A_z0_nl = idxmat([("z", i["k"], i["s"]) for i in inst])[:, :n_z] \
            if n_z else np.zeros((I, 0), int)
        A_coll_s = idxmat([("x_coll", i["k"], i["s"]) for i in inst]) \
            if (n_coll and self.n_nl_cons and st.nl_cons_check_colloc_points) \
            else np.zeros((I, 0), int)
        A_eps = idxmat([("eps", i["k_eps"], i["eps_s"]) for i in inst]) \
            if nev else np.zeros((I, 0), int)
        tvp_base = self._p_sl["tvp"].start
        A_tvp = np.stack([tvp_base + i["k"] * n_tvp + np.arange(n_tvp)
                          for i in inst]).astype(int)
        tvpN_idx = tvp_base + N * n_tvp + np.arange(n_tvp)
        p_base = self._p_sl["p"].start
        A_p = np.stack([p_base + i["p_idx"] * n_p + np.arange(n_p)
                        for i in inst]).astype(int)
        omega = np.array([1.0 / nscen[i["k"] + 1] for i in inst])
        term_mask = np.array([i["k"] == N - 1 for i in inst])
        A_term_node = np.stack([
            L.idx(("x_node", N, i["s"])) if i["k"] == N - 1
            else np.zeros(n_x, int) for i in inst])

        self._inst_arrays = dict(
            A_node=A_node, A_node_next=A_node_next, A_u=A_u,
            A_uprev=A_uprev, mask_k0=mask_k0, A_coll=A_coll,
            A_z_dyn=A_z_dyn, A_z_cost=A_z_cost, A_z0_nl=A_z0_nl,
            A_coll_s=A_coll_s, A_eps=A_eps, A_tvp=A_tvp, tvpN_idx=tvpN_idx,
            A_p=A_p, omega=omega, term_mask=term_mask,
            A_term_node=A_term_node)

        self._build_nlp_functions()

    def _build_nlp_functions(self):
        """Assemble the NLP callbacks with *instance-local* autodiff.

        Every (stage, scenario, branch) instance touches only a small
        variable vector v_i gathered from the flat decision vector; cost,
        constraints and all derivatives (gradient, Jacobians, Lagrangian
        Hessian) are computed per instance by vmapped ``torch.func``
        transforms and scatter-added into the global arrays.
        """
        st = self.settings
        model = self.model
        dev, dt = self._device, self._dtype
        n_x, n_u, n_z = model.n_x, model.n_u, model.n_z
        n_coll = self.n_total_coll_points
        n_coll_z = max(n_coll, 1) if n_z else 0
        nev = self.n_eps_vars
        n_nl = self.n_nl_cons
        I = self.n_instances
        L = self.layout
        n = L.size
        ia = self._inst_arrays
        xs = self._tensor(self._x_scaling.data)
        us = self._tensor(self._u_scaling.data)
        zs = self._tensor(self._z_scaling.data)
        psl = self._p_sl
        node00 = L.idx(("x_node", 0, 0))
        lterm, mterm = self._lterm, self._mterm
        rterm_sym = self._rterm_fun_sym
        rfac = self._tensor(self.rterm_factor.data)
        epsterm = self._epsterm_fun
        nl_cons_fun = self._nl_cons_fun
        stage_g = self._stage_g
        discrete = model.model_type == "discrete"
        check_colloc = st.nl_cons_check_colloc_points and n_coll > 0
        u_spec = model.spec("_u")

        # ---- per-instance variable vector v: segment layout ----
        seg_defs = [
            ("xk0", n_x), ("coll", n_coll * n_x), ("u", n_u),
            ("z", n_coll_z * n_z), ("uprev", n_u), ("eps", nev),
            ("node_next", n_x), ("term", n_x),
            ("coll_s", n_coll * n_x if (check_colloc and n_nl) else 0),
            ("z_s", n_coll_z * n_z if n_nl else 0),
        ]
        seg_sl = {}
        off = 0
        for name, size in seg_defs:
            seg_sl[name] = slice(off, off + size)
            off += size
        d = off
        self._inst_dim = d
        self._seg_sl = seg_sl

        # extended vector e = [w, u_prev_from_pvec(scaled), dummy]; columns
        # >= n are parameters/dummies and are dropped at scatter time
        uprev_pvec_cols = n + np.arange(n_u)
        dummy_col = n + n_u
        n_ext = n + n_u + 1

        A_all = np.zeros((I, d), dtype=int)
        A_all[:, seg_sl["xk0"]] = ia["A_node"]
        if n_coll:
            A_all[:, seg_sl["coll"]] = ia["A_coll"]
        if n_u:
            A_all[:, seg_sl["u"]] = ia["A_u"]
            A_all[:, seg_sl["uprev"]] = np.where(
                ia["mask_k0"][:, None], uprev_pvec_cols[None, :],
                ia["A_uprev"])
        if n_z:
            A_all[:, seg_sl["z"]] = ia["A_z_dyn"]
        if nev:
            A_all[:, seg_sl["eps"]] = ia["A_eps"]
        A_all[:, seg_sl["node_next"]] = ia["A_node_next"]
        A_all[:, seg_sl["term"]] = np.where(
            ia["term_mask"][:, None], ia["A_term_node"], dummy_col)
        if check_colloc and n_nl:
            A_all[:, seg_sl["coll_s"]] = ia["A_coll_s"]
        if n_nl and n_z:
            A_all[:, seg_sl["z_s"]] = np.stack(
                [L.idx(("z", i["k"], i["s"])) for i in self._instances])
        self._A_all = A_all
        A_all_t = _idx(A_all, dev)
        A_all_flat = A_all_t.reshape(-1)

        TVP = _idx(ia["A_tvp"], dev)      # index matrices into pvec
        PIDX = _idx(ia["A_p"], dev)
        tvpN_idx = _idx(ia["tvpN_idx"], dev)
        omega = self._tensor(ia["omega"])
        term_mask_f = self._tensor(ia["term_mask"].astype(float))
        node00_t = _idx(node00, dev)
        uprev_sl = psl["u_prev"]
        x0_sl = psl["x0"]

        def seg(v, name):
            return v[seg_sl[name]]

        def env_eval(expr, x, u, z, tvp, p, u_prev=None):
            env = model._env(x, u, z, tvp, p)
            if u_prev is not None:
                env["_u_prev"] = u_spec.unpack(u_prev, xp=torch)
            return model._flat(expr(env), 1, x).reshape(())

        # ---- per-instance scalar objective ----
        def obj_i(v, tvp, tvpN, p, om, tmask):
            x_un = seg(v, "xk0") * xs
            u_sc = seg(v, "u")
            u_un = u_sc * us
            zblk = seg(v, "z")
            z_cost = zblk[-n_z:] * zs if n_z else zblk[:0]
            val = om * env_eval(lterm, x_un, u_un, z_cost, tvp, p)
            val = val + tmask * om * env_eval(
                mterm, seg(v, "term") * xs, v.new_zeros((n_u,)),
                v.new_zeros((n_z,)), tvpN, p)
            if n_u:
                uprev_sc = seg(v, "uprev")
                if rterm_sym is not None:
                    val = val + om * env_eval(rterm_sym, x_un, u_un, z_cost,
                                              tvp, p, u_prev=uprev_sc)
                else:
                    val = val + om * torch.sum(rfac * (u_sc - uprev_sc) ** 2)
            if nev:
                val = val + epsterm(seg(v, "eps"))
            return val

        # ---- per-instance equality residual ----
        wnoise = self._tensor(np.zeros(model.n_w))

        def g_i(v, tvp, p):
            xk0 = seg(v, "xk0")
            u = seg(v, "u")
            z = seg(v, "z")
            if discrete:
                alg, x_pred = stage_g(xk0, v[:0], u, z, tvp, p, wnoise)
                return torch.cat([alg, x_pred - seg(v, "node_next")])
            coll = seg(v, "coll")
            res = stage_g(xk0, coll, u, z, tvp, p, wnoise)
            return torch.cat([res, coll[-n_x:] - seg(v, "node_next")])

        # ---- per-instance inequality residual ----
        def h_i(v, tvp, p):
            eps = seg(v, "eps")
            u_un = seg(v, "u") * us
            if check_colloc:
                outs = []
                coll_s = seg(v, "coll_s")
                z_s = seg(v, "z_s")
                for i in range(n_coll):
                    xi = coll_s[i * n_x:(i + 1) * n_x] * xs
                    zi = (z_s[i * n_z:(i + 1) * n_z] * zs if n_z
                          else v[:0])
                    outs.append(nl_cons_fun(xi, u_un, zi, tvp, p, eps))
                return torch.cat(outs)
            x_un = seg(v, "xk0") * xs
            z0 = seg(v, "z_s")[:n_z] * zs if n_z else v[:0]
            return nl_cons_fun(x_un, u_un, z0, tvp, p, eps)

        # instance row counts (one evaluation at zeros)
        v0 = self._tensor(np.zeros(d))
        tvp0, p0 = self._tensor(np.zeros(model.n_tvp)), \
            self._tensor(np.zeros(model.n_p))
        E = int(g_i(v0, tvp0, p0).shape[0])
        nlr = int(h_i(v0, tvp0, p0).shape[0]) if n_nl else 0
        m_eq = n_x + I * E
        q_ineq = I * nlr
        R_g = (n_x + np.arange(I)[:, None] * E + np.arange(E)[None, :])
        R_h = (np.arange(I)[:, None] * nlr + np.arange(nlr)[None, :]) \
            if nlr else np.zeros((I, 0), int)
        R_g_t = _idx(R_g, dev)
        R_h_t = _idx(R_h, dev)
        vmap = torch.func.vmap

        def gather(w, pvec):
            """Instance inputs of a batch (B, n), (B, n_p), flattened
            batch-major into B*I instances for one ``vmap``."""
            B = w.shape[0]
            parts = [w]
            if n_u:
                parts.append(pvec[:, uprev_sl] / us)
            parts.append(w.new_zeros((B, 1)))
            V = torch.cat(parts, dim=1)[:, A_all_t]

            def fl(x):
                return x.reshape((B * I,) + x.shape[2:])
            return (fl(V), fl(pvec[:, TVP]),
                    pvec[:, tvpN_idx].repeat_interleave(I, dim=0),
                    fl(pvec[:, PIDX]), omega.repeat(B),
                    term_mask_f.repeat(B))

        # ---- value functions ----
        def f(w, pvec):
            vals = vmap(obj_i)(*gather(w, pvec))
            return vals.reshape(w.shape[0], I).sum(1)

        def g(w, pvec):
            V, tvp, _, p, _, _ = gather(w, pvec)
            init = w[:, node00_t] - pvec[:, x0_sl] / xs
            res = vmap(g_i)(V, tvp, p)
            return torch.cat([init, res.reshape(w.shape[0], -1)], dim=1)

        def h(w, pvec):
            if q_ineq == 0:
                return w.new_zeros((w.shape[0], 0))
            V, tvp, _, p, _, _ = gather(w, pvec)
            return vmap(h_i)(V, tvp, p).reshape(w.shape[0], -1)

        # ---- derivative oracles (instance-local AD + scatter) ----
        # reverse mode throughout: in eager PyTorch on the CPU the
        # instance Jacobians and Hessians by jacrev (and jacrev of jacrev)
        # take 1/5 to 1/6 of the time of jacfwd (and jacfwd of jacrev, the
        # JAX package's hessian), with the same values to roundoff
        jacrev = torch.func.jacrev
        d_obj = torch.func.grad(obj_i)
        d_g = jacrev(g_i)
        d_h = jacrev(h_i) if nlr else None

        def grad_f(w, pvec):
            B = w.shape[0]
            G = vmap(d_obj)(*gather(w, pvec))
            return scatter_sum_cols(A_all_flat, G.reshape(B, -1),
                                    n_ext)[:, :n]

        init_row = torch.arange(n_x, device=dev)

        def scatter_rows(w, Ji, R_t, rows):
            """Scatter-add instance Jacobians (B*I, r, d) into (B, rows,
            n)."""
            B = w.shape[0]
            b_idx = torch.arange(B, device=dev)[:, None, None, None]
            J = w.new_zeros((B, rows, n_ext))
            J.index_put_((b_idx, R_t[None, :, :, None],
                          A_all_t[None, :, None, :]),
                         Ji.reshape((B,) + R_t.shape + (d,)),
                         accumulate=True)
            return J

        def jac_g(w, pvec):
            V, tvp, _, p, _, _ = gather(w, pvec)
            J = scatter_rows(w, vmap(d_g)(V, tvp, p), R_g_t, m_eq)
            J[:, init_row, node00_t] = 1.0
            return J[:, :, :n]

        def jac_h(w, pvec):
            V, tvp, _, p, _, _ = gather(w, pvec)
            return scatter_rows(w, vmap(d_h)(V, tvp, p), R_h_t,
                                q_ineq)[:, :, :n]

        def lag_i(v, tvp, tvpN, p, om, tmask, lam_gi, lam_hi):
            val = obj_i(v, tvp, tvpN, p, om, tmask)
            val = val + torch.dot(lam_gi, g_i(v, tvp, p))
            if nlr:
                val = val + torch.dot(lam_hi, h_i(v, tvp, p))
            return val

        d2_lag = jacrev(jacrev(lag_i))

        def inst_multipliers(lam_g, lam_h):
            """Per-instance multipliers (B*I, E), (B*I, nlr)."""
            Lg = lam_g[:, R_g_t].reshape(-1, E)
            Lh = lam_h[:, R_h_t].reshape(-1, nlr) if nlr \
                else lam_g.new_zeros((lam_g.shape[0] * I, 0))
            return Lg, Lh

        def hess_fn(w, pvec, lam_g, lam_h):
            B = w.shape[0]
            Hi = vmap(d2_lag)(*gather(w, pvec),
                              *inst_multipliers(lam_g, lam_h))
            b_idx = torch.arange(B, device=dev)[:, None, None, None]
            H = w.new_zeros((B, n_ext, n_ext))
            H.index_put_((b_idx, A_all_t[None, :, :, None],
                          A_all_t[None, :, None, :]),
                         Hi.reshape(B, I, d, d), accumulate=True)
            return H[:, :n, :n]

        self._f_fn, self._g_fn, self._h_fn = map(_any_batch, (f, g, h))
        self._grad_f_fn, self._jac_g_fn, self._jac_h_fn = map(
            _any_batch, (grad_f, jac_g, jac_h))
        self._hess_fn = _any_batch(hess_fn)
        self._rows_per_inst = E
        self._nl_rows_per_inst = nlr
        self._struct_parts = dict(
            gather=gather, inst_multipliers=inst_multipliers, d_g=d_g,
            d_h=d_h, d2_lag=d2_lag, nlr=nlr, I=I, d=d, R_g=R_g, R_h=R_h,
            lag_i=lag_i, g_i=g_i, h_i=(h_i if nlr else None))

        # sizes
        self.n_opt_lagr = m_eq
        self._n_ineq = q_ineq
        self.n_eps = nev * sum(1 for key in L.offsets if key[0] == "eps")

        # ---- aux over the horizon (reference opt_aux, _mpc.py:1277-1284:
        # evaluated per (k, s) at the interval-start node; unused scenario
        # columns are padded with the last computed (k, s) values, and the
        # z/p of the *last* branch win, as in the reference) ----
        tree = self.scenario_tree
        nscen = tree["n_scenarios"]
        child = tree["child_scenario"]
        boff = tree["branch_offset"]
        nbr = tree["n_branches"]
        N = st.n_horizon
        n_tvp, n_p = model.n_tvp, model.n_p
        n_max = nscen[-1]
        n_aux = model.n_aux
        self.n_opt_aux = N * n_max * n_aux
        ax = {nm: [] for nm in ("x", "u", "z", "tvp", "p")}
        for k in range(N):
            b_last = nbr[k] - 1
            for s in range(n_max):
                s_eff = min(s, nscen[k] - 1)
                s_u = 0 if st.open_loop else s_eff
                c = child[k][s_eff][b_last]
                ax["x"].append(L.idx(("x_node", k, s_eff)))
                ax["u"].append(L.idx(("u", k, s_u)) if n_u
                               else np.zeros(0, int))
                ax["z"].append(L.idx(("z", k, c))[-n_z:] if n_z
                               else np.zeros(0, int))
                ax["tvp"].append(psl["tvp"].start + k * n_tvp
                                 + np.arange(n_tvp))
                ax["p"].append(psl["p"].start + (b_last + boff[k][s_eff])
                               * n_p + np.arange(n_p))
        AX = {nm: _idx(np.stack(a), dev) for nm, a in ax.items()}
        aux_fun = model._aux_expression_fun

        def opt_aux_expression_fun(w, pvec):
            """(w scaled, pvec) -> (N*n_max, n_aux) aux values."""
            if not n_aux:
                return w.new_zeros((N * n_max, 0))
            return vmap(aux_fun)(w[AX["x"]] * xs, w[AX["u"]] * us,
                                 w[AX["z"]] * zs, pvec[AX["tvp"]],
                                 pvec[AX["p"]])

        self._opt_aux_fun = opt_aux_expression_fun

        # stage assignment of every KKT row
        w_stage = np.zeros(L.size, int)
        for key in L.offsets:
            w_stage[L.sl(key)] = L.stage_of[key]
        inst_k = np.array([i["k"] for i in self._instances], dtype=int)
        self._w_stage = w_stage
        self._g_stage = np.concatenate([np.zeros(n_x, int),
                                        np.repeat(inst_k, E)])
        self._h_stage = np.repeat(inst_k, nlr) if nlr else np.zeros(0, int)

    def _build_shift_maps(self):
        """Receding-horizon shift: source index of every primal/dual entry
        one stage ahead along the nominal branch; the last stage is
        duplicated.  Returns dict(w=, lam=, z=) of int arrays sized
        (n_w,), (m+q,), (n+q,)."""
        L = self.layout
        st = self.settings
        N = st.n_horizon
        child = self.scenario_tree["child_scenario"]
        n = L.size
        src_w = np.arange(n)

        def copy_from(dst_key, src_key):
            if src_key in L.offsets:
                src_w[L.sl(dst_key)] = L.idx(src_key)

        for key in list(L.offsets):
            kind, k = key[0], key[1]
            if kind == "x_node" and k < N:
                copy_from(key, ("x_node", k + 1, child[k][key[2]][0]))
            elif kind == "u" and k < N - 1:
                s2 = 0 if st.open_loop else child[k][key[2]][0]
                copy_from(key, ("u", k + 1, s2))
            elif kind in ("x_coll", "z") and k < N - 1:
                copy_from(key, (kind, k + 1, child[k + 1][key[2]][0]))
            elif kind == "eps" and k < N - 1:
                copy_from(key, ("eps", k + 1, child[k][key[2]][0]))

        # duals: instance (k, s, b) <- instance (k+1, child, b')
        inst_index = {(i["k"], i["s"], i["b"]): idx
                      for idx, i in enumerate(self._instances)}
        E, nlr = self._rows_per_inst, self._nl_rows_per_inst
        n_x = self.model.n_x
        src_inst = np.arange(self.n_instances)
        for idx, i in enumerate(self._instances):
            k, s, b = i["k"], i["s"], i["b"]
            if k >= N - 1:
                continue
            key2 = (k + 1, child[k][s][b], b if (k + 1) < st.n_robust else 0)
            if key2 in inst_index:
                src_inst[idx] = inst_index[key2]
        src_g = np.concatenate([
            np.arange(n_x),
            (n_x + src_inst[:, None] * E + np.arange(E)[None, :]).reshape(-1)])
        src_h = (src_inst[:, None] * nlr
                 + np.arange(nlr)[None, :]).reshape(-1) if nlr \
            else np.zeros(0, int)
        return dict(w=src_w, lam=np.concatenate([src_g,
                                                 self.n_opt_lagr + src_h]),
                    z=np.concatenate([src_w, n + src_h]))

    def _chain_assignment(self):
        """Chain/stage assignment of every variable, row and instance for
        the bordered-block-diagonal KKT factorization (solver/bbd.py).

        Leaf-scenario chains start where the scenario tree stops branching;
        everything shared across chains lands in the root border.
        Proposals are validated against actual instance usage
        (``demote_by_usage``)."""
        L = self.layout
        nscen = self.scenario_tree["n_scenarios"]
        n_max = nscen[-1]
        N = self.settings.n_horizon
        k0 = next(k for k in range(N + 1) if nscen[k] == n_max)
        shift = max(k0 - 1, 0)
        open_loop = self.settings.open_loop and n_max > 1

        var_chain = np.full(L.size, ROOT, int)
        var_stage = np.zeros(L.size, int)
        for key in L.offsets:
            kind, k = key[0], key[1]
            if kind == "x_node":
                ch = key[2] if nscen[k] == n_max else ROOT
            elif kind == "u":
                ch = key[2] if (not open_loop and nscen[k] == n_max) \
                    else ROOT
            elif kind == "eps":
                ch = key[2] if (nscen[k] == n_max
                                and key[2] < n_max) else ROOT
            elif kind in ("x_coll", "z"):
                ch = key[2] if nscen[k + 1] == n_max else ROOT
            else:
                ch = ROOT
            sl = L.sl(key)
            var_chain[sl] = ch
            var_stage[sl] = max(k - shift, 0) if ch != ROOT else 0

        inst_chain = np.array([
            i["c"] if nscen[i["k"] + 1] == n_max else ROOT
            for i in self._instances], int)
        inst_stage = np.array([max(i["k"] - shift, 0)
                               for i in self._instances], int)
        var_chain, var_stage = demote_by_usage(
            var_chain, var_stage, self._A_all, L.size, inst_chain,
            inst_stage)

        E, nlr = self._rows_per_inst, self._nl_rows_per_inst
        n_x = self.model.n_x
        init_cols = L.idx(("x_node", 0, 0))
        g_chain = np.concatenate([
            np.full(n_x, var_chain[init_cols[0]]),
            np.repeat(inst_chain, E)])
        g_stage = np.concatenate([
            np.full(n_x, var_stage[init_cols[0]]),
            np.repeat(inst_stage, E)])
        h_chain = np.repeat(inst_chain, nlr)
        h_stage = np.repeat(inst_stage, nlr)
        return (var_chain, var_stage, g_chain, g_stage, h_chain, h_stage,
                init_cols)

    def _prepare_fn(self):
        """``prepare(w, pvec, lam_g, lam_h, sig_w, inv_sig_s)`` of both
        structured backends: instance derivatives at the current points of
        a batch, ``Hi`` (B, I, d, d), ``Jg_i`` (B, I, E, d), ``Jh_i`` (B,
        I, nlr, d), from three independent vmapped transforms over the B*I
        instances (the JAX package's default, unfused form)."""
        sp = self._struct_parts
        gather, nlr, I, d = sp["gather"], sp["nlr"], sp["I"], sp["d"]
        d_g, d_h, d2_lag = sp["d_g"], sp["d_h"], sp["d2_lag"]
        vmap = torch.func.vmap

        def prepare(w, pvec, lam_g, lam_h, sig_w, inv_sig_s):
            B = w.shape[0]
            V, tvp, tvpN, p, om, tm = gather(w, pvec)
            Hi = vmap(d2_lag)(V, tvp, tvpN, p, om, tm,
                              *sp["inst_multipliers"](lam_g, lam_h))
            Jg_i = vmap(d_g)(V, tvp, p)
            Jh_i = vmap(d_h)(V, tvp, p) if nlr else V.new_zeros((B * I, 0, d))
            return tuple(x.reshape((B, I) + x.shape[1:])
                         for x in (Hi, Jg_i, Jh_i)) + (sig_w, inv_sig_s)
        return prepare

    def _make_structured_solve(self, delta_cons, n_refine=1):
        """Uncondensed structured KKT backend: instance derivative tensors
        are gathered into per-scenario-chain band blocks plus a root border
        and solved by the band sweep with a Schur complement on the root
        (solver/bbd.py).  Works on (B, ...) batches; the band backend is
        chosen here, once (``DOMPC_TPU_BAND_BACKEND``)."""
        sp = self._struct_parts
        chains = self._chain_assignment()
        assembler = BBDAssembler(
            *chains[:6], self._A_all, sp["R_g"], sp["R_h"], self.n_opt_x,
            self.n_opt_lagr, self._n_ineq, chains[6], device=self._device)
        self._kkt_structure = assembler
        m = self.n_opt_lagr
        prepare_derivs = self._prepare_fn()

        def prepare(w, pvec, lam_g, lam_h, sig_w, inv_sig_s):
            Hi, Jg_i, Jh_i, _, _ = prepare_derivs(w, pvec, lam_g, lam_h,
                                                  sig_w, inv_sig_s)
            return assembler.assemble(
                Hi, Jg_i, Jh_i, sig_w,
                -delta_cons * w.new_ones((w.shape[0], m)),
                -inv_sig_s - delta_cons)

        return prepare, bbd_kkt_solve(
            assembler, self._dtype, band_backend(self._dtype, self._device),
            n_refine)

    def _nl_cons_z_independent(self):
        """Probe whether the nl_cons rows are structurally independent of
        the algebraic variables: their Jacobian columns on the ``z_s``
        segment vanish at several random points (the Sym layer has no
        sparsity query).  ``condense_z='never'`` is the escape hatch."""
        if getattr(self.settings, "condense_z", "auto") == "never":
            return False
        sp = getattr(self, "_struct_parts", None)
        if sp is None or sp.get("d_h") is None:
            return True
        seg = self._seg_sl["z_s"]
        if seg.stop == seg.start:
            return True
        d_h = sp["d_h"]
        rng = np.random.default_rng(0)
        domains = [(-1.9, -0.2), (0.3, 1.1), (-3.0, 3.0), (-0.05, 0.05)]
        for lo, hi in domains + [(0.3, 1.1)] * 2:
            v = self._tensor(rng.uniform(lo, hi, sp["d"]))
            tvp = self._tensor(rng.uniform(lo, hi, self.model.n_tvp))
            p = self._tensor(rng.uniform(0.3, 1.1, self.model.n_p))
            J = d_h(v, tvp, p).cpu().numpy()
            if np.any(J[:, seg] != 0.0):
                return False
        return True

    def _condensation_plan(self):
        """Select the per-instance interior (collocation states/algebraics
        + their residual rows) that stage condensation can eliminate, or
        None when the transcription couples interiors across instances."""
        st = self.settings
        n_x, n_z = self.model.n_x, self.model.n_z
        n_coll = self.n_total_coll_points
        seg_sl = self._seg_sl
        E = self._rows_per_inst
        if st.nl_cons_check_colloc_points and self.n_nl_cons:
            return None
        if n_z and self.n_nl_cons and not self._nl_cons_z_independent():
            return None         # z referenced by nl_cons rows (z_s segment)
        int_cols = []
        if n_coll:
            int_cols.append(np.arange(seg_sl["coll"].start,
                                      seg_sl["coll"].stop))
        if n_z:
            int_cols.append(np.arange(seg_sl["z"].start, seg_sl["z"].stop))
        if not int_cols:
            return None
        int_cols = np.concatenate(int_cols)
        if E - n_x != len(int_cols):
            return None         # interior not square; play safe
        int_rows = np.arange(E - n_x)
        bnd_rows = np.arange(E - n_x, E)
        bnd_cols = np.setdiff1d(np.arange(self._inst_dim), int_cols)
        A_int = self._A_all[:, int_cols]
        # each interior column must be owned by exactly one instance
        vals, counts = np.unique(A_int.reshape(-1), return_counts=True)
        if np.any(counts != 1) or np.any(vals >= self.n_opt_x):
            return None
        return dict(int_cols=int_cols, bnd_cols=bnd_cols,
                    int_rows=int_rows, bnd_rows=bnd_rows, A_int=A_int)

    def _make_condensed_solve(self, delta_cons, n_refine=1):
        """Condensed structured KKT backend: per-instance collocation
        interiors are Schur-eliminated by batched dense solves, then the
        small boundary band (block size O(n_x + n_u)) is swept by the BBD
        path (solver/bbd.py:CondensedAssembler)."""
        plan = self._condensation_plan()
        assert plan is not None, "condensation not applicable here"
        sp = self._struct_parts
        dev = self._device
        (var_chain, var_stage, g_chain, g_stage, h_chain, h_stage,
         init_cols) = self._chain_assignment()
        n, m, q = self.n_opt_x, self.n_opt_lagr, self._n_ineq
        n_x = self.model.n_x
        R_g, R_h = sp["R_g"], sp["R_h"]
        I, nlr = sp["I"], sp["nlr"]
        int_cols, bnd_cols = plan["int_cols"], plan["bnd_cols"]
        int_rows, bnd_rows = plan["int_rows"], plan["bnd_rows"]
        A_int = plan["A_int"]
        R_g_int = R_g[:, int_rows]
        skip_var = np.zeros(n, bool)
        skip_var[A_int.reshape(-1)] = True
        skip_g = np.zeros(m, bool)
        skip_g[R_g_int.reshape(-1)] = True

        assembler = CondensedAssembler(
            var_chain, var_stage, g_chain, g_stage, h_chain, h_stage,
            self._A_all[:, bnd_cols], R_g[:, bnd_rows], R_h, n, m, q,
            init_cols, skip_var, skip_g, device=dev)
        self._kkt_structure_cond = assembler

        n_iv, n_bv = len(int_cols), len(bnd_cols)
        n_ir, n_br = len(int_rows), len(bnd_rows)
        n_be = n_bv + n_br + nlr
        ic, bc = _idx(int_cols, dev), _idx(bnd_cols, dev)
        ir, br = _idx(int_rows, dev), _idx(bnd_rows, dev)
        A_int_t = _idx(A_int, dev)
        A_int_flat = A_int_t.reshape(-1)
        R_g_int_t = _idx(R_g_int, dev)
        R_g_int_flat = R_g_int_t.reshape(-1)
        R_h_flat = _idx(R_h.reshape(-1), dev) if nlr else None
        prepare = self._prepare_fn()

        backend = band_backend(self._dtype, dev)

        def solve(ctx, r_dw, r_g, r_h_mod, delta):
            Hi, Jg_i, Jh_i, sig_w, inv_sig_s = ctx      # (B, I, ...)
            B = Hi.shape[0]
            b_w, b_g = -r_dw, -r_g
            b_h = -r_h_mod if q else r_dw.new_zeros((B, 0))

            H_ii = Hi[:, :, ic[:, None], ic[None, :]]
            H_ib = Hi[:, :, ic[:, None], bc[None, :]]
            H_bb = Hi[:, :, bc[:, None], bc[None, :]]
            Jg_int = Jg_i[:, :, ir]             # (B, I, n_ir, d)
            Jg_bnd = Jg_i[:, :, br]             # (B, I, n_br, d)
            J_ii = Jg_int[..., ic]
            J_ib = Jg_int[..., bc]
            Jb_ii = Jg_bnd[..., ic]             # bnd rows x int cols
            Jb_ib = Jg_bnd[..., bc]
            sig_int = sig_w[:, A_int_t] + delta[:, None, None]  # (B,I,n_iv)
            eye_ir = torch.eye(n_ir, dtype=Hi.dtype, device=Hi.device)

            def T_(x):
                return x.transpose(-1, -2)

            M_ii = torch.cat([
                torch.cat([H_ii + torch.diag_embed(sig_int), T_(J_ii)],
                          dim=-1),
                torch.cat([J_ii, (-delta_cons * eye_ir).expand(
                    B, I, n_ir, n_ir)], dim=-1)], dim=-2)

            top = [H_ib, T_(Jb_ii)]
            if nlr:
                Jh_int = Jh_i[..., ic]
                Jh_bnd = Jh_i[..., bc]
                top.append(T_(Jh_int))
            M_ib = torch.cat([
                torch.cat(top, dim=-1),
                torch.cat([J_ib, Hi.new_zeros((B, I, n_ir, n_be - n_bv))],
                          dim=-1)], dim=-2)

            # boundary block (rows diag: -delta_cons for eq rows,
            # -(inv_sig_s + delta_cons) for h rows)
            rows = [torch.cat([H_bb, T_(Jb_ib)]
                              + ([T_(Jh_bnd)] if nlr else []), dim=-1),
                    torch.cat([Jb_ib,
                               Hi.new_zeros((B, I, n_br, n_br + nlr))],
                              dim=-1)]
            if nlr:
                rows.append(torch.cat(
                    [Jh_bnd, Hi.new_zeros((B, I, nlr, n_br + nlr))],
                    dim=-1))
            M_bb = torch.cat(rows, dim=-2)
            diag_rows = torch.cat([
                Hi.new_zeros((B, I, n_bv)),
                Hi.new_full((B, I, n_br), -delta_cons),
                (-(inv_sig_s[:, R_h_flat].reshape(B, I, nlr) + delta_cons)
                 if nlr else Hi.new_zeros((B, I, 0)))], dim=-1)
            M_bb = M_bb + torch.diag_embed(diag_rows)

            b_int = torch.cat([b_w[:, A_int_t], b_g[:, R_g_int_t]], dim=-1)
            rhs_int = torch.cat([M_ib, b_int[..., None]], dim=-1)
            Y = torch.linalg.solve_ex(M_ii, rhs_int)[0]   # no raise/sync
            C_i = M_bb - torch.einsum("...ij,...ik->...jk", M_ib,
                                      Y[..., :n_be])
            corr = torch.einsum("...ij,...i->...j", M_ib, Y[..., n_be])

            D, U, Lo, Bord, Root = assembler.assemble(
                C_i, sig_w + delta[:, None],
                Hi.new_full((B, n_x), -delta_cons))
            rhs_c, rhs_r = assembler.pack_rhs(b_w, b_g, b_h)
            rhs_c, rhs_r = assembler.add_corrections(rhs_c, rhs_r, corr)
            n_ref = 0 if r_dw.dtype == torch.float32 else n_refine
            x_c, x_r = bbd_solve(D, U, Lo, Bord, Root, rhs_c, rhs_r,
                                 n_refine=n_ref, backend=backend)
            dw, dg, dh, x_ent = assembler.unpack_sol(x_c, x_r)
            x_int = Y[..., n_be] - torch.einsum("...ib,...b->...i",
                                                Y[..., :n_be], x_ent)
            dw[:, A_int_flat] = x_int[..., :n_iv].reshape(B, -1)
            dg[:, R_g_int_flat] = x_int[..., n_iv:].reshape(B, -1)
            return dw, dg, dh

        return prepare, solve

    def _make_kkt_backend(self, delta_cons, n_refine=1, allow_condensed=True):
        """Pick the structured KKT backend: condensed band when the
        transcription allows it, plain BBD band otherwise."""
        st = self.settings
        if (allow_condensed and st.kkt_solver in ("auto", "condensed")
                and self._condensation_plan() is not None):
            return self._make_condensed_solve(delta_cons, n_refine=n_refine)
        return self._make_structured_solve(delta_cons, n_refine=n_refine)

    def _create_solver(self):
        st = self.settings
        ipm_settings = ipm_settings_from(st)
        n_stages = st.n_horizon + 1
        use_structured = (st.kkt_solver in ("tridiag", "condensed")
                          or (st.kkt_solver == "auto"
                              and self.n_opt_x > 600 and n_stages >= 4))
        structured_solve = None
        if use_structured:
            structured_solve = self._make_kkt_backend(
                ipm_settings.delta_cons)
        self._solve_raw = make_ipm_solver(
            self._f_fn, self._g_fn, self._h_fn,
            self._lb_opt_x, self._ub_opt_x,
            self.n_opt_lagr, self._n_ineq, settings=ipm_settings,
            hess_fn=self._hess_fn,
            grad_f_fn=self._grad_f_fn,
            jac_g_fn=self._jac_g_fn if self.n_instances else None,
            jac_h_fn=self._jac_h_fn if self._n_ineq else None,
            structured_solve=structured_solve,
            dtype=self._dtype, device=self._device)
        self._optx_resolver = make_mpc_resolver(self)
        self._bnb = None    # branch-and-bound over this solver's oracles
        self.opt_x_num = np.zeros(self.n_opt_x)
        self.opt_p_num = np.zeros(self.n_opt_p)
        self.lam_g_num = np.zeros(self.n_opt_lagr + self._n_ineq)

    def _prepare_data(self):
        """Reference: optimizer.py:448-481."""
        self.data.data_fields.update({"_eps": self.n_eps})
        self.data.data_fields.update({"opt_p_num": self.n_opt_p})
        if self.settings.store_full_solution:
            self.data.data_fields.update({"_opt_x_num": self.n_opt_x})
            self.data.data_fields.update({"_opt_aux_num": self.n_opt_aux})
            self.data._pred_layout = _PredictionLayout(self)
        if self.settings.store_lagr_multiplier:
            self.data.data_fields.update(
                {"_lam_g_num": self.n_opt_lagr + self._n_ineq})
        for stat in self.settings.store_solver_stats:
            self.data.data_fields.update({stat: 1})
        meta = {k: getattr(self.settings, k)
                for k in ("n_horizon", "n_robust", "open_loop", "t_step",
                          "state_discretization", "collocation_type",
                          "collocation_deg", "collocation_ni",
                          "store_full_solution")}
        meta["structure_scenario"] = self.scenario_tree["structure_scenario"]
        self.data.set_meta(**meta)
        self.data.init_storage()

    # ------------------------------------------------------------ runtime --
    def reset_history(self):
        """Clear logged data and reset time (reference API)."""
        self._t0 = np.array([0.0])
        self.data.init_storage()

    def set_initial_guess(self):
        """Broadcast x0/u0/z0 into the decision vector
        (reference: _mpc.py:955)."""
        assert self.flags["setup"], "MPC was not setup yet."
        L = self.layout
        w = self.opt_x_num
        x0s = self._x0.data / self._x_scaling.data
        u0s = self._u0.data / self._u_scaling.data
        z0s = (self._z0.data / self._z_scaling.data if self.model.n_z
               else np.zeros(0))
        n_coll_z = max(self.n_total_coll_points, 1)
        for key in L.offsets:
            kind = key[0]
            if kind == "x_node":
                w[L.sl(key)] = x0s
            elif kind == "x_coll":
                w[L.sl(key)] = np.tile(x0s, self.n_total_coll_points)
            elif kind == "u":
                w[L.sl(key)] = u0s
            elif kind == "z":
                w[L.sl(key)] = np.tile(z0s, n_coll_z)
            elif kind == "eps":
                w[L.sl(key)] = 0.0
        self.flags["set_initial_guess"] = True

    def _assemble_opt_p(self, x0):
        pvec = np.zeros(self.n_opt_p)
        pvec[self._p_sl["x0"]] = np.asarray(x0, dtype=float).reshape(-1)
        if self.model.n_tvp:
            pvec[self._p_sl["tvp"]] = self._eval_tvp(self._t0).reshape(-1)
        if self.model.n_p:
            p0 = self.p_fun(float(self._t0[0]))
            arr = p0.array() if hasattr(p0, "array") else np.asarray(p0)
            pvec[self._p_sl["p"]] = arr.reshape(-1)
        pvec[self._p_sl["u_prev"]] = self._u0.data
        return pvec

    def solve(self):
        """Solve with the current ``opt_p_num`` (reference:
        optimizer.py:731-787).  Warm-starts from the previous solution."""
        assert self.flags["setup"], "MPC was not setup yet."
        t_start = _time.perf_counter()
        self._n_solves = getattr(self, "_n_solves", 0) + 1
        T = self._tensor
        with profiler.step_annotation("dompc_tpu_torch.MPC.solve",
                                      self._n_solves):
            # a batch of one instance; element 0 is read below
            if self.flags["initial_run"]:
                sol = self._solve_raw(
                    T(self.opt_x_num)[None], T(self.opt_p_num)[None],
                    T(self._lam_warm)[None], self.settings.warm_start_mu,
                    T(self._zl_warm)[None], T(self._zu_warm)[None])
            else:
                sol = self._solve_raw(T(self.opt_x_num)[None],
                                      T(self.opt_p_num)[None])

        def host(a):
            return a[0].detach().to("cpu", torch.float64).numpy()

        w = host(sol.w)
        self._last_sol = sol
        self.opt_x_num = w
        self.opt_x_num_unscaled = w * self.opt_x_scaling
        self._lam_warm = host(sol.lam)
        self._zl_warm = host(sol.zl)
        self._zu_warm = host(sol.zu)
        self.lam_g_num = self._lam_warm
        success = bool(sol.success[0])
        self.solver_stats = {
            "success": success,
            "iter_count": int(sol.iterations[0]),
            "t_wall_total": _time.perf_counter() - t_start,
            "return_status": "Solve_Succeeded" if success
            else "Maximum_Iterations_Exceeded",
            "kkt_err": float(sol.kkt_err[0]),
        }
        self.flags["initial_run"] = True

    def _integer_mask(self):
        u_spec = self.model.spec("_u")
        int_mask = np.zeros(self.model.n_u, bool)
        for name in self.model.integer_u:
            int_mask[u_spec.slice(name)] = True
        return int_mask

    def _integer_w_indices(self):
        """Indices into opt_x of every integer-input entry over the horizon
        and scenarios, plus the per-entry scaling (integrality holds for
        w * scale)."""
        L = self.layout
        int_mask = self._integer_mask()
        all_idx = np.arange(L.size)
        idx, sc = [], []
        for key in L.offsets:
            if key[0] == "u":
                idx.append(all_idx[L.sl(key)][int_mask])
                sc.append(self._u_scaling.data[int_mask])
        return np.concatenate(idx), np.concatenate(sc)

    def _integer_solution(self):
        """Integer inputs (the reference delegates to BONMIN): ``"bnb"``
        runs batched branch-and-bound below the relaxation just solved
        (solver/minlp.py); ``"round"``, or bnb finding nothing, rounds the
        relaxation, exact whenever it is near-integral."""
        st = self.settings
        if st.minlp_strategy == "bnb":
            if self._bnb is None:
                idx, sc = self._integer_w_indices()
                self._bnb = BranchAndBound(
                    self, idx, sc, tol=st.solver_tol,
                    max_iter=st.solver_max_iter,
                    batch_width=st.bnb_batch_width,
                    max_nodes=st.bnb_max_nodes)
            res = self._bnb.refine(self.opt_p_num, self._last_sol)
            self.solver_stats["bnb_nodes"] = res.n_nodes
            if res.success:
                # the integral primal becomes the solution (and the next
                # warm start); the duals stay those of the relaxation: the
                # next step warm-starts the relaxation, not the node
                self.opt_x_num = res.w
                self.opt_x_num_unscaled = res.w * self.opt_x_scaling
                return
        L = self.layout
        us = self._u_scaling.data
        int_mask = self._integer_mask()
        for key in L.offsets:
            if key[0] == "u":
                blk = self.opt_x_num[L.sl(key)] * us
                blk[int_mask] = np.round(blk[int_mask])
                self.opt_x_num[L.sl(key)] = blk / us

    def make_step(self, x0) -> np.ndarray:
        """One closed-loop control step (reference: _mpc.py:975-1059)."""
        assert self.flags["setup"], "MPC was not setup yet."
        x0 = np.asarray(x0, dtype=float).reshape(-1)
        assert x0.size == self.model.n_x
        if not self.flags["set_initial_guess"]:
            warnings.warn("Initial guess for the MPC was not set.")
            self.flags["set_initial_guess"] = True

        self.opt_p_num = self._assemble_opt_p(x0)
        self.solve()
        if self.model.integer_u:
            self._integer_solution()

        L = self.layout
        u0 = self.opt_x_num[L.sl(("u", 0, 0))] * self._u_scaling.data
        if self.model.n_z:
            z0 = self.opt_x_num[L.idx(("z", 0, 0))[:self.model.n_z]] \
                * self._z_scaling.data
        else:
            z0 = np.zeros(0)
        tvp0 = self.opt_p_num[self._p_sl["tvp"]][:self.model.n_tvp]
        p0 = self.opt_p_num[self._p_sl["p"]][:self.model.n_p]
        # full aux trajectory; aux0 = opt_aux_num['_aux', 0, 0]
        self.opt_aux_num = self._opt_aux_fun(
            self._tensor(self.opt_x_num),
            self._tensor(self.opt_p_num)).to("cpu", torch.float64).numpy()
        aux0 = self.opt_aux_num[0]

        self.data.update(_x=x0)
        self.data.update(_u=u0)
        self.data.update(_z=z0)
        self.data.update(_tvp=tvp0)
        self.data.update(_p=p0)
        self.data.update(_time=self._t0)
        self.data.update(_aux=aux0)
        self.data.update(opt_p_num=self.opt_p_num)
        if self.settings.store_full_solution:
            self.data.update(_opt_x_num=self.opt_x_num_unscaled)
            self.data.update(_opt_aux_num=self.opt_aux_num)
        if self.settings.store_lagr_multiplier:
            self.data.update(_lam_g_num=self.lam_g_num)
        stats_row = {k: v for k, v in self.solver_stats.items()
                     if k in self.settings.store_solver_stats}
        if stats_row:
            self.data.update(**{k: float(v) for k, v in stats_row.items()})

        self._t0 = self._t0 + self.settings.t_step
        self._x0.data[:] = x0
        self._u0.data[:] = u0
        self._z0.data[:] = z0 if self.model.n_z else self._z0.data
        return u0.reshape(-1, 1)


class _PredictionLayout:
    """Reconstructs prediction trajectories from the flat solution
    (reference: data.py:246-372)."""

    def __init__(self, mpc):
        self.layout = mpc.layout
        self.N = mpc.settings.n_horizon
        self.tree = mpc.scenario_tree
        self.model_specs = {vt: mpc.model.spec(vt) for vt in
                            ("_x", "_u", "_z", "_aux")}
        self.open_loop = mpc.settings.open_loop
        self.n_coll = mpc.n_total_coll_points
        self.n_aux = mpc.model.n_aux

    def extract(self, w, field, name, elem=None):
        L = self.layout
        n_max = self.tree["n_scenarios"][-1]
        struct = self.tree["structure_scenario"]
        spec = self.model_specs[field]
        sl = spec.slice(name)
        cols = []
        if field == "_x":
            for scol in range(n_max):
                traj = [w[L.sl(("x_node", k, struct[k][scol]))][sl]
                        for k in range(self.N + 1)]
                cols.append(np.stack(traj))
        elif field == "_u":
            for scol in range(n_max):
                traj = [w[L.sl(("u", k, 0 if self.open_loop
                                else struct[k][scol]))][sl]
                        for k in range(self.N)]
                cols.append(np.stack(traj))
        elif field == "_z":
            nz = spec.size
            for scol in range(n_max):
                traj = [w[L.idx(("z", k, struct[k + 1][scol]))[-nz:]][sl]
                        for k in range(self.N)]
                cols.append(np.stack(traj))
        out = np.stack(cols, axis=-1)  # (horizon, n_elem, n_scen)
        out = np.moveaxis(out, 1, 0)   # (n_elem, horizon, n_scen)
        if elem is not None:
            out = out[np.asarray(elem).reshape(-1)]
        return out

    def extract_aux(self, aux_row, name, elem=None):
        """Aux prediction from a stored _opt_aux_num row
        (reference: data.py:246-372, '_aux' branch)."""
        n_max = self.tree["n_scenarios"][-1]
        struct = self.tree["structure_scenario"]
        sl = self.model_specs["_aux"].slice(name)
        A = np.asarray(aux_row).reshape(self.N, n_max, self.n_aux)
        cols = [np.stack([A[k, struct[k][scol]][sl] for k in range(self.N)])
                for scol in range(n_max)]
        out = np.moveaxis(np.stack(cols, axis=-1), 1, 0)
        if elem is not None:
            out = out[np.asarray(elem).reshape(-1)]
        return out
