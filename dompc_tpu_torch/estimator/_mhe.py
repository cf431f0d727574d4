"""Moving-horizon estimator (PyTorch port).

Counterpart of the JAX package's ``estimator/_mhe.py`` (reference:
do_mpc/estimator/_mhe.py:36-1261), with the same NLP: optional parameter
estimation (the ``p_est_list`` split), arrival and stage cost
(``set_objective``, ``set_default_objective``), measurement-sequence
templates (``get_y_template``/``set_y_fun``, by default the estimator's
own measurement history), and collocation, continuity and
measurement-equality constraints.

The N stages of the horizon are N instances of one small variable vector
(the stage's nodes, collocation points, inputs, noises, slacks and the
estimated parameters); cost, constraints and every derivative are
instance-local ``torch.func`` transforms under ``vmap``, scattered into the
global arrays.  The oracles and the structured KKT backend take a leading
batch axis, as the MPC's do; ``make_step`` solves a batch of one.

The estimated parameters couple every stage: the structured KKT backend
(``kkt_solver="tridiag"``, or ``"auto"`` above 600 variables) factors the
stage band with them in the root border of the bordered-band system
(solver/bbd.py), whose chain sweep is the CUDA band kernel on the card.
Device and dtype are read from the environment at ``setup()``, as for the
MPC.
"""
from __future__ import annotations

import time as _time
import warnings

import numpy as np
import torch

from .._config import resolve_device, resolve_dtype
from ..controller._mpc import _any_batch, _idx
from ..model._iteratedvariables import IteratedVariables
from ..model._model import SymView
from ..optimizer import Optimizer, OCPLayout, make_stage_residual
from ..tools import NumStruct, StructSpec
from ..tools import _profiler as profiler
from ..tools._optxview import make_mhe_resolver
from ..data import Data
from ..solver.ipm import ipm_settings_from
from ..solver.bbd import (BBDAssembler, bbd_kkt_solve, band_backend,
                          demote_by_usage, scatter_sum_cols)
from .. import sym as casym
from ._estimatorsettings import MHESettings


class _YTemplate:
    """Measurement-sequence template: ``y_template['y_meas', k] = ...``."""

    def __init__(self, n_horizon, n_y):
        self._data = np.zeros((n_horizon, n_y))

    def __setitem__(self, key, value):
        if isinstance(key, tuple) and key[0] == "y_meas":
            key = key[1:]
        k = key[0] if isinstance(key, tuple) else key
        self._data[k] = np.asarray(value, dtype=float).reshape(-1)

    def __getitem__(self, key):
        if isinstance(key, tuple) and key[0] == "y_meas":
            key = key[1:]
        if key == () or key is None:
            return self._data
        return self._data[key]

    def array(self):
        return self._data


class MHE(Optimizer, IteratedVariables):
    """Moving horizon estimator (reference: estimator/_mhe.py:36)."""

    # power-index extension: bounds/scaling on estimated parameters
    # (reference: optimizer.py:305,334,404,428)
    _BOUND_MAP = {**Optimizer._BOUND_MAP,
                  ("lower", "_p_est"): "_p_est_lb",
                  ("upper", "_p_est"): "_p_est_ub"}
    _SCALING_MAP = {**Optimizer._SCALING_MAP, "_p_est": "_p_est_scaling"}

    def __init__(self, model, p_est_list=()):
        assert model.flags["setup"], "Model must be setup before MHE."
        self._init_iterated_variables(model)
        self._init_optimizer()
        self.settings = MHESettings()
        self.data = Data(model)
        self.flags = {
            "setup": False, "set_objective": False, "set_tvp_fun": False,
            "set_p_fun": False, "set_y_fun": False,
            "set_initial_guess": False, "initial_run": False,
        }
        # split p into estimated / set parameters (reference :162-188)
        p_spec = model.spec("_p")
        self._p_est_spec = StructSpec(
            [(n, p_spec.shapes[n]) for n in p_spec.names if n in p_est_list])
        self._p_set_spec = StructSpec(
            [(n, p_spec.shapes[n]) for n in p_spec.names
             if n not in p_est_list])
        self.n_p_est = self._p_est_spec.size
        self.n_p_set = self._p_set_spec.size
        self._p_est0 = NumStruct(self._p_est_spec)
        self._p_est_scaling = NumStruct(self._p_est_spec, 1.0)
        self._p_est_lb = NumStruct(self._p_est_spec, -np.inf)
        self._p_est_ub = NumStruct(self._p_est_spec, np.inf)
        self._stage_cost = None
        self._arrival_cost = None
        self.y_fun = None
        self._nl_cons_extra_specs = {"_p_est": self._p_est_spec,
                                     "_p_set": self._p_set_spec,
                                     "_x_prev": model.spec("_x")}

    # ------------------------------------------------------- sym accessors
    @property
    def _x(self): return self.model.x
    @property
    def _w(self): return SymView("_w", self.model.spec("_w"))
    @property
    def _v(self): return SymView("_v", self.model.spec("_v"))
    @property
    def _x_prev(self): return SymView("_x_prev", self.model.spec("_x"))
    @property
    def _p_est(self): return SymView("_p_est", self._p_est_spec)
    @property
    def _p_est_prev(self): return SymView("_p_est_prev", self._p_est_spec)
    @property
    def _p_set(self): return SymView("_p_set", self._p_set_spec)

    def _p_cat(self, p_est_vec, p_set_vec):
        """Recombine est/set parameters (numpy arrays or tensors, last axis)
        into the model p order (reference ``_p_cat_fun``)."""
        parts = []
        ei = si = 0
        for name in self.model.spec("_p").names:
            if name in self._p_est_spec:
                sz = self._p_est_spec.block_size(name)
                parts.append(p_est_vec[..., ei:ei + sz])
                ei += sz
            else:
                sz = self._p_set_spec.block_size(name)
                parts.append(p_set_vec[..., si:si + sz])
                si += sz
        if isinstance(p_est_vec, torch.Tensor):
            return torch.cat(parts, dim=-1) if parts else p_est_vec[..., :0]
        return np.concatenate(parts, axis=-1) if parts else np.zeros((0,))

    # ------------------------------------------------------------- config
    def set_objective(self, stage_cost, arrival_cost):
        assert not self.flags["setup"]
        self._stage_cost = casym.to_sym(stage_cost)
        self._arrival_cost = casym.to_sym(arrival_cost)
        self.flags["set_objective"] = True

    def set_default_objective(self, P_x, P_v=None, P_p=None, P_w=None):
        """Weighted-norm default objective (reference :602-715).
        Weights may be numeric or Sym (e.g. tvp entries)."""
        model = self.model
        stage = casym.to_sym(0.0)
        if P_v is not None:
            v = self._v.cat
            stage = stage + casym.mtimes(casym.mtimes(v.T, P_v), v)
        else:
            assert model.n_v == 0, "P_v required (model has meas noise)."
        if P_w is not None:
            w = self._w.cat
            stage = stage + casym.mtimes(casym.mtimes(w.T, P_w), w)
        else:
            assert model.n_w == 0, "P_w required (model has process noise)."
        dx = self._x.cat - self._x_prev.cat
        arrival = casym.mtimes(casym.mtimes(dx.T, P_x), dx)
        if P_p is not None:
            dp = self._p_est.cat - self._p_est_prev.cat
            arrival = arrival + casym.mtimes(casym.mtimes(dp.T, P_p), dp)
        else:
            assert self.n_p_est == 0, "P_p required (estimating parameters)."
        self.set_objective(stage, arrival)

    def get_p_template(self):
        return NumStruct(self._p_set_spec)

    def set_p_fun(self, p_fun):
        self.p_fun = p_fun
        self.flags["set_p_fun"] = True

    def get_y_template(self):
        return _YTemplate(self.settings.n_horizon, self.model.n_y)

    def set_y_fun(self, y_fun):
        self.y_fun = y_fun
        self.flags["set_y_fun"] = True

    @property
    def p_est0(self):
        return self._p_est0

    @p_est0.setter
    def p_est0(self, val):
        v = np.asarray(val, dtype=float).reshape(-1)
        if v.size == 1:
            v = np.full(self._p_est_spec.size, v[0])
        self._p_est0.master = v

    def _tvp_template_len(self):
        return self.settings.n_horizon

    def _tensor(self, a):
        """numpy -> tensor of the estimator's dtype and device."""
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    # --------------------------------------------------------------- setup
    def setup(self):
        self._device = resolve_device()
        self._dtype = resolve_dtype()
        st = self.settings
        st.check_for_mandatory_settings()
        model = self.model
        self._setup_nl_cons()
        if not self.flags["set_objective"]:
            raise RuntimeError("Objective undefined: call set_objective() "
                               "or set_default_objective().")
        if not self.flags["set_tvp_fun"] and model.n_tvp > 0:
            raise RuntimeError("Model has tvp but set_tvp_fun() not called.")
        if not self.flags["set_p_fun"] and self.n_p_set > 0:
            raise RuntimeError("Set parameters require set_p_fun().")
        if self.n_p_set == 0 and self.p_fun is None:
            tmpl = self.get_p_template()
            self.set_p_fun(lambda t: tmpl)
        if not self.flags["set_y_fun"]:
            # default: read own measurement history (reference :842-856)
            y_template = self.get_y_template()

            def y_fun(t_now):
                n_steps = min(self.data._y.shape[0], st.n_horizon)
                for k in range(-n_steps, 0):
                    y_template["y_meas", k] = self.data._y[k]
                for k in range(st.n_horizon - n_steps):
                    if n_steps > 0:
                        y_template["y_meas", k] = self.data._y[-n_steps]
                return y_template
            self.set_y_fun(y_fun)

        n_x, n_u, n_z = model.n_x, model.n_u, model.n_z
        n_w, n_v, n_y = model.n_w, model.n_v, model.n_y
        n_tvp = model.n_tvp
        N = st.n_horizon
        nev = self.n_eps_vars
        n_eps_rep = 1 if st.nl_cons_single_slack else N

        stage_g, n_coll = make_stage_residual(
            model, st, self._x_scaling.data, self._z_scaling.data,
            self._u_scaling.data)
        self.n_total_coll_points = n_coll
        n_coll_z = max(n_coll, 1) if n_z else 0

        # ----- layout: single chain + per-stage w/v + global p_est -----
        L = OCPLayout()
        for k in range(N):
            L.add(("x_node", k, 0), n_x, k)
            if n_u:
                L.add(("u", k, 0), n_u, k)
            if n_w:
                L.add(("w", k), n_w, k)
            if n_v:
                L.add(("v", k), n_v, k)
            if k < n_eps_rep and nev:
                L.add(("eps", k, 0), nev, k)
            if n_coll:
                L.add(("x_coll", k, 0), n_coll * n_x, k)
            if n_z:
                L.add(("z", k, 0), n_coll_z * n_z, k)
        L.add(("x_node", N, 0), n_x, N)
        if self.n_p_est:
            L.add(("p_est",), self.n_p_est, N)
        self.layout = L
        self.n_opt_x = L.size

        # scaling / bounds over w
        scal = np.ones(L.size)
        lb = np.full(L.size, -np.inf)
        ub = np.full(L.size, np.inf)
        xs, us, zs = (self._x_scaling.data, self._u_scaling.data,
                      self._z_scaling.data)
        for key in L.offsets:
            kind = key[0]
            if kind == "x_node":
                scal[L.sl(key)] = xs
                if 1 <= key[1] <= N:
                    lb[L.sl(key)] = self._x_lb.data / xs
                    ub[L.sl(key)] = self._x_ub.data / xs
            elif kind == "x_coll":
                scal[L.sl(key)] = np.tile(xs, n_coll)
                if st.cons_check_colloc_points and key[1] <= N - 1:
                    lb[L.sl(key)] = np.tile(self._x_lb.data / xs, n_coll)
                    ub[L.sl(key)] = np.tile(self._x_ub.data / xs, n_coll)
            elif kind == "z":
                scal[L.sl(key)] = np.tile(zs, n_coll_z)
                lb[L.sl(key)] = np.tile(self._z_lb.data / zs, n_coll_z)
                ub[L.sl(key)] = np.tile(self._z_ub.data / zs, n_coll_z)
            elif kind == "u":
                scal[L.sl(key)] = us
                lb[L.sl(key)] = self._u_lb.data / us
                ub[L.sl(key)] = self._u_ub.data / us
            elif kind == "eps":
                lb[L.sl(key)] = self._eps_lb
                ub[L.sl(key)] = self._eps_ub
            elif kind == "p_est":
                pes = self._p_est_scaling.data
                scal[L.sl(key)] = pes
                lb[L.sl(key)] = self._p_est_lb.data / pes
                ub[L.sl(key)] = self._p_est_ub.data / pes
        self.opt_x_scaling = scal
        self._lb_opt_x = lb
        self._ub_opt_x = ub

        # opt_p layout: [x_prev, p_est_prev, p_set, tvp(N), y_meas(N)]
        self._p_sl = {}
        off = 0
        for name, size in [("x_prev", n_x), ("p_est_prev", self.n_p_est),
                           ("p_set", self.n_p_set), ("tvp", N * n_tvp),
                           ("y_meas", N * n_y)]:
            self._p_sl[name] = slice(off, off + size)
            off += size
        self.n_opt_p = off

        self._build_nlp_functions(stage_g, n_coll, n_coll_z)
        self._create_solver()
        self._prepare_data()
        self.flags["setup"] = True
        return self

    # ---------------------------------------------------------- functions
    def _build_nlp_functions(self, stage_g, n_coll, n_coll_z):
        """The NLP with instance-local autodiff: stage k's variables gather
        into one vector v_k, and the objective, the constraints and all
        their derivatives are per instance (vmapped ``torch.func``) with a
        scatter into the global arrays.  The estimated parameters ride in
        every instance, so they land in the root border of the bordered
        band."""
        st = self.settings
        model = self.model
        dev = self._device
        meta = (self._dtype, dev)
        n_x, n_u, n_z = model.n_x, model.n_u, model.n_z
        n_w, n_v, n_y, n_tvp = (model.n_w, model.n_v, model.n_y,
                                model.n_tvp)
        N = st.n_horizon
        nev = self.n_eps_vars
        n_nl = self.n_nl_cons
        n_pe = self.n_p_est
        L = self.layout
        n = L.size
        psl = self._p_sl
        T = self._tensor
        xs = T(self._x_scaling.data)
        us = T(self._u_scaling.data)
        zs = T(self._z_scaling.data)
        pes = T(self._p_est_scaling.data)
        n_eps_rep = 1 if st.nl_cons_single_slack else N
        check_colloc = st.nl_cons_check_colloc_points and n_coll > 0
        discrete = model.model_type == "discrete"
        stage_cost, arrival = self._stage_cost, self._arrival_cost
        nl_list = self.nl_cons_list
        slack_names = {s["slack_name"] for s in self.slack_vars_list}
        eps_spec = self._eps_spec
        nl_ub = T(self._nl_cons_ub)
        epsterm = self._epsterm_fun
        spec = {vt: model.spec(vt) for vt in ("_x", "_w", "_v", "_tvp", "_p")}
        pe_spec, ps_spec = self._p_est_spec, self._p_set_spec

        def unpack(sp, vec):
            return sp.unpack(vec, xp=torch)

        def scalar(expr, env, ref):
            return model._flat(expr(env), 1, ref).reshape(())

        def nl_cons_eval(x, u, z, tvp, p_est, p_set, eps):
            env = model._env(x, u, z, tvp, self._p_cat(p_est, p_set))
            env["_p_est"] = unpack(pe_spec, p_est)
            env["_p_set"] = unpack(ps_spec, p_set)
            parts = []
            for c in nl_list:
                val = model._flat(c["expr"](env), int(np.prod(c["shape"])), x)
                if c["expr_name"] in slack_names:
                    val = val - eps[eps_spec.slice(c["expr_name"])]
                parts.append(val)
            return torch.cat(parts) - nl_ub

        # ---- per-instance variable vector v: segment layout ----
        seg_defs = [
            ("node", n_x), ("coll", n_coll * n_x), ("u", n_u),
            ("z", n_coll_z * n_z), ("w", n_w), ("v", n_v), ("eps", nev),
            ("node_next", n_x), ("p_est", n_pe),
        ]
        seg_sl = {}
        off = 0
        for name, size in seg_defs:
            seg_sl[name] = slice(off, off + size)
            off += size
        d = off

        def seg(v, name):
            return v[seg_sl[name]]

        def stage_cols(k):
            return {
                "node": L.idx(("x_node", k, 0)),
                "coll": L.idx(("x_coll", k, 0)) if n_coll else [],
                "u": L.idx(("u", k, 0)) if n_u else [],
                "z": L.idx(("z", k, 0)) if n_z else [],
                "w": L.idx(("w", k)) if n_w else [],
                "v": L.idx(("v", k)) if n_v else [],
                "eps": L.idx(("eps", min(k, n_eps_rep - 1), 0))
                if nev else [],
                "node_next": L.idx(("x_node", k + 1, 0)),
                "p_est": L.idx(("p_est",)) if n_pe else [],
            }

        A_all = np.zeros((N, d), dtype=int)
        for k in range(N):
            cols = stage_cols(k)
            for name, _ in seg_defs:
                A_all[k, seg_sl[name]] = cols[name]
        self._A_all = A_all
        A_all_t = _idx(A_all, dev)
        A_all_flat = A_all_t.reshape(-1)
        A_tvp = _idx(psl["tvp"].start + np.arange(N)[:, None] * n_tvp
                     + np.arange(n_tvp)[None, :], dev)
        A_y = _idx(psl["y_meas"].start + np.arange(N)[:, None] * n_y
                   + np.arange(n_y)[None, :], dev)
        k0_mask = T((np.arange(N) == 0).astype(float))

        # ---- per-instance scalar objective ----
        def obj_i(v, tvp, k0m, x_prev, p_est_prev, p_set):
            p_est = seg(v, "p_est") * pes
            p = self._p_cat(p_est, p_set)
            env = {
                "_w": unpack(spec["_w"], seg(v, "w")),
                "_v": unpack(spec["_v"], seg(v, "v")),
                "_tvp": unpack(spec["_tvp"], tvp),
                "_p": unpack(spec["_p"], p),
                "_p_est": unpack(pe_spec, p_est),
                "_p_set": unpack(ps_spec, p_set),
                casym.META: meta,
            }
            val = scalar(stage_cost, env, v)
            env_arr = {
                "_x": unpack(spec["_x"], seg(v, "node") * xs),
                "_x_prev": unpack(spec["_x"], x_prev),
                "_p_est": env["_p_est"],
                "_p_est_prev": unpack(pe_spec, p_est_prev),
                "_p_set": env["_p_set"],
                "_p": env["_p"],
                casym.META: meta,
            }
            val = val + k0m * scalar(arrival, env_arr, v)
            if nev:
                val = val + epsterm(seg(v, "eps"))
            return val

        # ---- per-instance equality residual: dynamics + measurements ----
        def g_i(v, tvp, y, p_set):
            p = self._p_cat(seg(v, "p_est") * pes, p_set)
            node, u, z = seg(v, "node"), seg(v, "u"), seg(v, "z")
            wk, node_next = seg(v, "w"), seg(v, "node_next")
            if discrete:
                alg, x_pred = stage_g(node, v[:0], u, z, tvp, p, wk)
                res = [alg, x_pred - node_next]
            else:
                coll = seg(v, "coll")
                res = [stage_g(node, coll, u, z, tvp, p, wk),
                       coll[-n_x:] - node_next]
            z_end = z[-n_z:] if n_z else v[:0]
            # measurement equality (reference :1144-1160)
            y_calc = model._meas_fun(node_next * xs, u * us, z_end * zs,
                                     tvp, p, seg(v, "v"))
            res.append(y_calc - y)
            return torch.cat(res)

        # ---- per-instance inequality residual ----
        def h_i(v, tvp, p_set):
            p_est = seg(v, "p_est") * pes
            u_un = seg(v, "u") * us
            z, eps = seg(v, "z"), seg(v, "eps")
            if check_colloc:
                coll = seg(v, "coll")
                return torch.cat([
                    nl_cons_eval(coll[i * n_x:(i + 1) * n_x] * xs, u_un,
                                 z[i * n_z:(i + 1) * n_z] * zs if n_z
                                 else v[:0], tvp, p_est, p_set, eps)
                    for i in range(n_coll)])
            z0 = z[:n_z] * zs if n_z else v[:0]
            return nl_cons_eval(seg(v, "node") * xs, u_un, z0, tvp, p_est,
                                p_set, eps)

        # instance row counts (one evaluation at zeros)
        v0, tvp0, y0, ps0 = (T(np.zeros(s)) for s in (d, n_tvp, n_y,
                                                       self.n_p_set))
        E = int(g_i(v0, tvp0, y0, ps0).shape[0])
        nlr = int(h_i(v0, tvp0, ps0).shape[0]) if n_nl else 0
        m, q = N * E, N * nlr
        self.n_opt_lagr = m
        self._n_ineq = q
        self.n_eps = nev * min(n_eps_rep, N)
        R_g = np.arange(N)[:, None] * E + np.arange(E)[None, :]
        R_h = np.arange(N)[:, None] * nlr + np.arange(nlr)[None, :]
        R_g_t, R_h_t = _idx(R_g, dev), _idx(R_h, dev)
        vmap = torch.func.vmap

        def gather(w, pvec):
            """Instance inputs of a batch (B, n), (B, n_p), flattened
            batch-major into B*N instances for one ``vmap``."""
            B = w.shape[0]

            def per_inst(sl):
                return pvec[:, sl].repeat_interleave(N, dim=0)
            return (w[:, A_all_t].reshape(B * N, d),
                    pvec[:, A_tvp].reshape(B * N, n_tvp),
                    pvec[:, A_y].reshape(B * N, n_y), k0_mask.repeat(B),
                    per_inst(psl["x_prev"]), per_inst(psl["p_est_prev"]),
                    per_inst(psl["p_set"]))

        # ---- value functions ----
        def f(w, pvec):
            V, TV, _, K0, XP, PEP, PS = gather(w, pvec)
            return vmap(obj_i)(V, TV, K0, XP, PEP, PS).reshape(
                w.shape[0], N).sum(1)

        def g(w, pvec):
            V, TV, Y, _, _, _, PS = gather(w, pvec)
            return vmap(g_i)(V, TV, Y, PS).reshape(w.shape[0], -1)

        def h(w, pvec):
            if not q:
                return w.new_zeros((w.shape[0], 0))
            V, TV, _, _, _, _, PS = gather(w, pvec)
            return vmap(h_i)(V, TV, PS).reshape(w.shape[0], -1)

        # ---- derivative oracles (instance-local AD + scatter), reverse
        # mode as the MPC's (the JAX package takes jacfwd and hessian;
        # the values agree to roundoff) ----
        jacrev = torch.func.jacrev
        d_obj = torch.func.grad(obj_i)
        d_g = jacrev(g_i)
        d_h = jacrev(h_i) if nlr else None

        def grad_f(w, pvec):
            V, TV, _, K0, XP, PEP, PS = gather(w, pvec)
            G = vmap(d_obj)(V, TV, K0, XP, PEP, PS)
            return scatter_sum_cols(A_all_flat, G.reshape(w.shape[0], -1), n)

        def scatter_rows(w, Ji, R_t, rows):
            """Scatter-add instance Jacobians (B*N, r, d) into (B, rows,
            n) (sorted, deterministic accumulation)."""
            B = w.shape[0]
            b_idx = torch.arange(B, device=dev)[:, None, None, None]
            J = w.new_zeros((B, rows, n))
            J.index_put_((b_idx, R_t[None, :, :, None],
                          A_all_t[None, :, None, :]),
                         Ji.reshape((B,) + R_t.shape + (d,)),
                         accumulate=True)
            return J

        def jac_g(w, pvec):
            V, TV, Y, _, _, _, PS = gather(w, pvec)
            return scatter_rows(w, vmap(d_g)(V, TV, Y, PS), R_g_t, m)

        def jac_h(w, pvec):
            V, TV, _, _, _, _, PS = gather(w, pvec)
            return scatter_rows(w, vmap(d_h)(V, TV, PS), R_h_t, q)

        def lag_i(v, tvp, y, k0m, x_prev, p_est_prev, p_set, lam_gi,
                  lam_hi):
            val = obj_i(v, tvp, k0m, x_prev, p_est_prev, p_set)
            val = val + torch.dot(lam_gi, g_i(v, tvp, y, p_set))
            if nlr:
                val = val + torch.dot(lam_hi, h_i(v, tvp, p_set))
            return val

        d2_lag = jacrev(jacrev(lag_i))

        def inst_hess(w, pvec, lam_g, lam_h):
            """Instance Hessians of the Lagrangian, (B, N, d, d)."""
            B = w.shape[0]
            Hi = vmap(d2_lag)(*gather(w, pvec),
                              lam_g[:, R_g_t].reshape(B * N, E),
                              lam_h[:, R_h_t].reshape(B * N, nlr))
            return Hi.reshape(B, N, d, d)

        def inst_derivs(w, pvec, lam_g, lam_h):
            """Instance Hessians (B, N, d, d) and constraint Jacobians
            (B, N, E, d), (B, N, nlr, d)."""
            B = w.shape[0]
            V, TV, Y, _, _, _, PS = gather(w, pvec)
            Jg_i = vmap(d_g)(V, TV, Y, PS)
            Jh_i = vmap(d_h)(V, TV, PS) if nlr \
                else V.new_zeros((B * N, 0, d))
            return (inst_hess(w, pvec, lam_g, lam_h),
                    Jg_i.reshape(B, N, E, d), Jh_i.reshape(B, N, nlr, d))

        def hess_fn(w, pvec, lam_g, lam_h):
            B = w.shape[0]
            b_idx = torch.arange(B, device=dev)[:, None, None, None]
            H = w.new_zeros((B, n, n))
            H.index_put_((b_idx, A_all_t[None, :, :, None],
                          A_all_t[None, :, None, :]),
                         inst_hess(w, pvec, lam_g, lam_h), accumulate=True)
            return H

        self._f_fn, self._g_fn, self._h_fn = map(_any_batch, (f, g, h))
        self._grad_f_fn, self._jac_g_fn, self._jac_h_fn = map(
            _any_batch, (grad_f, jac_g, jac_h))
        self._hess_fn = _any_batch(hess_fn)
        self._struct_parts = dict(inst_derivs=inst_derivs, R_g=R_g, R_h=R_h,
                                  E=E, nlr=nlr, N=N)

    def _make_kkt_backend(self, kkt, delta_cons, n_refine, graphs):
        """The structured KKT backend of :meth:`Optimizer._make_solver`,
        for every ``kkt`` the bordered band: a single stage chain with the
        estimated parameters (and single-slack eps) in the BBD root
        (reference hands this sparsity to IPOPT, estimator/_mhe.py:1251;
        p_est couples every stage, which is exactly the arrowhead border
        solver/bbd.py factorizes).  Its derivatives evaluate eagerly, not
        through ``graphs``."""
        sp = self._struct_parts
        L = self.layout
        N, E, nlr = sp["N"], sp["E"], sp["nlr"]
        m = self.n_opt_lagr
        var_stage = np.zeros(L.size, int)
        for key in L.offsets:
            var_stage[L.sl(key)] = min(L.stage_of[key], N)
        inst_chain = np.zeros(N, int)
        inst_stage = np.arange(N)
        var_chain, var_stage = demote_by_usage(
            np.zeros(L.size, int), var_stage, self._A_all, L.size,
            inst_chain, inst_stage)
        assembler = BBDAssembler(
            var_chain, var_stage, np.repeat(inst_chain, E),
            np.repeat(inst_stage, E), np.repeat(inst_chain, nlr),
            np.repeat(inst_stage, nlr), self._A_all, sp["R_g"], sp["R_h"],
            self.n_opt_x, m, self._n_ineq, None, device=self._device)
        self._kkt_structure = assembler
        inst_derivs = sp["inst_derivs"]

        def prepare(w, pvec, lam_g, lam_h, sig_w, inv_sig_s):
            Hi, Jg_i, Jh_i = inst_derivs(w, pvec, lam_g, lam_h)
            return assembler.assemble(
                Hi, Jg_i, Jh_i, sig_w,
                -delta_cons * w.new_ones((w.shape[0], m)),
                -inv_sig_s - delta_cons)

        return prepare, bbd_kkt_solve(
            assembler, self._dtype, band_backend(self._dtype, self._device),
            n_refine)

    def _create_solver(self):
        st = self.settings
        use_structured = (st.kkt_solver == "tridiag"
                          or (st.kkt_solver == "auto"
                              and self.n_opt_x > 600
                              and st.n_horizon >= 4))
        self._solve_raw = self._make_solver(
            ipm_settings_from(st), "bbd" if use_structured else "dense")
        self._optx_resolver = make_mhe_resolver(self)
        self.opt_x_num = np.zeros(self.n_opt_x)
        self.opt_p_num = np.zeros(self.n_opt_p)
        self.lam_g_num = np.zeros(self.n_opt_lagr + self._n_ineq)

    def _prepare_data(self):
        self.data.data_fields.update({"_eps": self.n_eps})
        if self.settings.store_full_solution:
            self.data.data_fields.update({"_opt_x_num": self.n_opt_x})
        if self.settings.store_lagr_multiplier:
            self.data.data_fields.update(
                {"_lam_g_num": self.n_opt_lagr + self._n_ineq})
        for stat in self.settings.store_solver_stats:
            self.data.data_fields.update({stat: 1})
        self.data.init_storage()

    # ------------------------------------------------------------ runtime
    def reset_history(self):
        """Clear logged data and reset time (reference API)."""
        self._t0 = np.array([0.0])
        self.data.init_storage()

    def set_initial_guess(self):
        assert self.flags["setup"], "MHE was not setup yet."
        L = self.layout
        w = self.opt_x_num
        x0s = self._x0.data / self._x_scaling.data
        for key in L.offsets:
            kind = key[0]
            if kind == "x_node":
                w[L.sl(key)] = x0s
            elif kind == "x_coll":
                w[L.sl(key)] = np.tile(x0s, len(L.idx(key)) // len(x0s))
            elif kind == "u":
                w[L.sl(key)] = self._u0.data / self._u_scaling.data
            elif kind == "z":
                nrep = len(L.idx(key)) // max(self.model.n_z, 1)
                w[L.sl(key)] = np.tile(
                    self._z0.data / self._z_scaling.data, nrep)
            elif kind == "p_est":
                w[L.sl(key)] = self._p_est0.data / self._p_est_scaling.data
            else:
                w[L.sl(key)] = 0.0
        self.flags["set_initial_guess"] = True

    def _num(self, v):
        if isinstance(v, NumStruct):
            return v.data
        if hasattr(v, "array"):
            return np.asarray(v.array(), dtype=float)
        return np.asarray(v, dtype=float)

    def solve(self):
        """Solve with the current ``opt_p_num``, warm-started from the
        previous solution after the first call."""
        t_start = _time.perf_counter()
        self._n_solves = getattr(self, "_n_solves", 0) + 1
        T = self._tensor
        with profiler.step_annotation("dompc_tpu_torch.MHE.solve",
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

        self.opt_x_num = host(sol.w)
        self.opt_x_num_unscaled = self.opt_x_num * self.opt_x_scaling
        self._lam_warm = host(sol.lam)
        self._zl_warm = host(sol.zl)
        self._zu_warm = host(sol.zu)
        self.lam_g_num = self._lam_warm
        self.solver_stats = {
            "success": bool(sol.success[0]),
            "iter_count": int(sol.iterations[0]),
            "t_wall_total": _time.perf_counter() - t_start,
            "kkt_err": float(sol.kkt_err[0]),
        }
        self.flags["initial_run"] = True

    def make_step(self, y0) -> np.ndarray:
        """Estimation step (reference: _mhe.py:896-993)."""
        assert self.flags["setup"], "MHE was not setup yet."
        model = self.model
        y0 = np.asarray(y0, dtype=float).reshape(-1)
        assert y0.size == model.n_y
        if not self.flags["set_initial_guess"]:
            warnings.warn("Initial guess for the MHE was not set.")
            self.flags["set_initial_guess"] = True

        self.data.update(_y=y0)
        L = self.layout
        psl = self._p_sl
        t0 = self._t0
        xs = self._x_scaling.data
        tvp_arr = self._eval_tvp(t0)
        p_set0 = self._num(self.p_fun(float(t0[0]))).reshape(-1)
        y_traj = self._num(self.y_fun(float(t0[0])))

        pvec = np.zeros(self.n_opt_p)
        if self.flags["initial_run"]:
            # shifted arrival point from the previous solution (ref :945)
            pvec[psl["x_prev"]] = self.opt_x_num[
                L.sl(("x_node", 1, 0))] * xs
        else:
            pvec[psl["x_prev"]] = self._x0.data
        pvec[psl["p_est_prev"]] = self._p_est0.data
        pvec[psl["p_set"]] = p_set0
        if model.n_tvp:
            pvec[psl["tvp"]] = tvp_arr.reshape(-1)
        pvec[psl["y_meas"]] = y_traj.reshape(-1)
        self.opt_p_num = pvec

        self.solve()

        N = self.settings.n_horizon
        x_next = self.opt_x_num[L.sl(("x_node", N, 0))] * xs
        p_est_next = (self.opt_x_num[L.sl(("p_est",))]
                      * self._p_est_scaling.data if self.n_p_est
                      else np.zeros(0))
        u0 = (self.opt_x_num[L.sl(("u", N - 1, 0))]
              * self._u_scaling.data if model.n_u else np.zeros(0))
        z0 = (self.opt_x_num[L.idx(("z", N - 1, 0))[-model.n_z:]]
              * self._z_scaling.data if model.n_z else np.zeros(0))
        p0 = self._p_cat(self._p_est0.data, p_set0)

        self.data.update(_x=self._x0.data)
        self.data.update(_u=u0)
        self.data.update(_z=z0)
        self.data.update(_p=p0)
        if model.n_tvp:
            self.data.update(_tvp=tvp_arr[-1])
        self.data.update(_time=t0)
        if self.settings.store_full_solution:
            self.data.update(_opt_x_num=self.opt_x_num_unscaled)
        if self.settings.store_lagr_multiplier:
            self.data.update(_lam_g_num=self.lam_g_num)
        stats_row = {k: v for k, v in self.solver_stats.items()
                     if k in self.settings.store_solver_stats}
        if stats_row:
            self.data.update(**{k: float(v) for k, v in stats_row.items()})

        self._t0 = self._t0 + self.settings.t_step
        self._x0.data[:] = x_next
        if self.n_p_est:
            self._p_est0.data[:] = p_est_next
        if model.n_u:
            self._u0.data[:] = u0
        if model.n_z:
            self._z0.data[:] = z0
        return x_next.reshape(-1, 1)
