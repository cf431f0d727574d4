"""The multi-stage NMPC transcription, written out again in plain PyTorch.

do-mpc's robust multi-stage MPC (``do_mpc/optimizer.py``,
``do_mpc/controller/_mpc.py``) as the benchmarked configurations use it:
a scenario tree that branches over every combination of the uncertain
parameters for the first ``n_robust`` stages, orthogonal collocation on
finite elements for the continuous dynamics, scaled decision variables,
soft nonlinear constraints with a slack per stage and scenario, and the
input-rate penalty against the previous input.  The decision vector is
laid out stage-major in the port's order, so that a solution the port
returns, with its multipliers, can be judged here row for row; what each
row means is built from the configuration file and the model module
alone.

Only what the configurations need is written: no algebraic states, no
time-varying parameters, nonlinear constraints checked at the interval
starts.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


def radau_points(deg):
    """Right Radau (Radau IIA) collocation points on (0, 1], CasADi's
    convention: the roots of P_deg(2t - 1) - P_{deg-1}(2t - 1), Legendre
    polynomials P, which include t = 1."""
    from numpy.polynomial import legendre as leg
    c = np.zeros(deg + 1)
    c[deg] = 1.0
    c[deg - 1] = -1.0
    roots = np.sort(np.real(leg.legroots(c)))
    return (roots + 1.0) / 2.0


def legendre_points(deg):
    x, _ = np.polynomial.legendre.leggauss(deg)
    return np.sort((x + 1.0) / 2.0)


def lagrange(deg, scheme):
    """(C, D): C[j, r] the derivative of the j-th Lagrange basis polynomial
    on tau = [0, points] at tau[r]; D[j] its value at 1."""
    pts = radau_points(deg) if scheme == "radau" else legendre_points(deg)
    tau = np.concatenate([[0.0], pts])
    n = deg + 1
    C = np.zeros((n, n))
    D = np.zeros(n)
    for j in range(n):
        poly = np.poly1d([1.0])
        for r in range(n):
            if r != j:
                poly = poly * np.poly1d([1.0, -tau[r]]) / (tau[j] - tau[r])
        D[j] = poly(1.0)
        dpoly = poly.deriv()
        for r in range(n):
            C[j, r] = dpoly(tau[r])
    return C, D


def scenario_tree(n_comb, N, n_robust):
    """Branches per stage, scenarios per stage, child and parent scenario
    and the parameter-combination offset, as do-mpc counts them."""
    n_branches = [n_comb if k < n_robust else 1 for k in range(N)]
    n_scen = [n_comb ** min(k, n_robust) for k in range(N + 1)]
    child, parent, boff = {}, {}, {}
    for k in range(N):
        counter = 0
        for s in range(n_scen[k]):
            for b in range(n_branches[k]):
                child[k, s, b] = counter
                parent[k + 1, counter] = s
                counter += 1
            boff[k, s] = 0 if (n_robust == 0 or k < n_robust) \
                else s % n_branches[0]
    return n_branches, n_scen, child, parent, boff


def _named(spec, names, default):
    """The values of ``spec`` (a name -> number mapping) in ``names``'
    order, ``default`` where a name is missing or null."""
    vals = [spec.get(nm) for nm in names]
    return np.array([default if v is None else float(v) for v in vals])


class Transcription:
    """The NLP of one configuration: ``min f(w) s.t. g(w) = 0, h(w) <= 0,
    lb <= w <= ub`` for a given initial state x0.

    ``ocp`` is the configuration file's ``ocp`` object; ``model`` the
    reference module with ``rhs(x, u, p)``, ``lterm(x, u, p)``,
    ``mterm(x, p)`` and ``nl_cons(name, x, u, p)`` on unscaled tensors whose
    last axis holds the variables in the file's order."""

    def __init__(self, ocp, model):
        self.model = model
        xn, un, pn = ocp["x"], ocp["u"], ocp["p"]
        nx, nu = len(xn), len(un)
        self.nx, self.nu = nx, nu
        N = int(ocp["n_horizon"])
        self.N = N
        col = ocp["collocation"]
        deg, ni = int(col["deg"]), int(col["ni"])
        self.deg, self.ni = deg, ni
        self.C, self.D = lagrange(deg, col["type"])
        self.h_el = float(ocp["t_step"]) / ni
        n_coll = ni * (deg + 1)
        self.n_coll = n_coll
        self.xs = _named(ocp.get("x_scaling", {}), xn, 1.0)
        self.us = _named(ocp.get("u_scaling", {}), un, 1.0)

        unc = ocp.get("uncertainty", {})
        values = [np.asarray(unc.get(nm, [0.0]), dtype=float) for nm in pn]
        combos = np.array(list(itertools.product(*values)), dtype=float)
        n_comb = combos.shape[0]
        nbr, nscen, child, parent, boff = scenario_tree(
            n_comb, N, int(ocp["n_robust"]))

        soft = ocp.get("soft_constraints", [])
        hard = ocp.get("nl_constraints", [])
        self.nl = [(c["name"], float(c["ub"]), True) for c in soft] + \
            [(c["name"], float(c["ub"]), False) for c in hard]
        nev = len(soft)
        self.soft_pen = np.array([float(c["penalty"]) for c in soft])
        eps_ub = np.array([np.inf if c.get("maximum_violation") is None
                           else float(c["maximum_violation"]) for c in soft])

        # ---- layout (stage-major, the port's order) ----
        off = {}
        size = 0

        def add(key, n):
            nonlocal size
            off[key] = (size, n)
            size += n
        for k in range(N):
            for s in range(nscen[k]):
                add(("x", k, s), nx)
            for s in range(nscen[k]):
                add(("u", k, s), nu)
            if nev:
                for s in range(nscen[k]):
                    add(("eps", k, s), nev)
            for c in range(nscen[k + 1]):
                add(("coll", k, c), n_coll * nx)
        for s in range(nscen[N]):
            add(("x", N, s), nx)
        self.n = size
        self.off = off

        def idx(key):
            o, n = off[key]
            return np.arange(o, o + n)

        # ---- bounds ----
        xl = _named(ocp.get("x_lower", {}), xn, -np.inf) / self.xs
        xu = _named(ocp.get("x_upper", {}), xn, np.inf) / self.xs
        ul = _named(ocp.get("u_lower", {}), un, -np.inf) / self.us
        uu = _named(ocp.get("u_upper", {}), un, np.inf) / self.us
        lb = np.full(size, -np.inf)
        ub = np.full(size, np.inf)
        colloc_bounds = bool(ocp.get("cons_check_colloc_points", True))
        for key, (o, n) in off.items():
            kind, k = key[0], key[1]
            if kind == "x" and 1 <= k <= N - 1:
                lb[o:o + n], ub[o:o + n] = xl, xu
            elif kind == "coll" and colloc_bounds and k <= N - 2:
                lb[o:o + n] = np.tile(xl, n_coll)
                ub[o:o + n] = np.tile(xu, n_coll)
            elif kind == "u":
                lb[o:o + n], ub[o:o + n] = ul, uu
            elif kind == "eps":
                lb[o:o + n], ub[o:o + n] = 0.0, eps_ub
        self.lb, self.ub = lb, ub

        # ---- instances (k, s, b) ----
        rows = dict(node=[], nxt=[], coll=[], u=[], uprev=[], eps=[],
                    term=[], p=[], om=[], k0=[], last=[])
        dummy_x = np.zeros(nx, int)
        for k in range(N):
            for s in range(nscen[k]):
                for b in range(nbr[k]):
                    c = child[k, s, b]
                    rows["node"].append(idx(("x", k, s)))
                    rows["nxt"].append(idx(("x", k + 1, c)))
                    rows["coll"].append(idx(("coll", k, c)))
                    rows["u"].append(idx(("u", k, s)))
                    rows["uprev"].append(
                        idx(("u", k - 1, parent[k, s])) if k > 0
                        else np.zeros(nu, int))
                    rows["eps"].append(idx(("eps", k, s)) if nev
                                       else np.zeros(0, int))
                    rows["term"].append(idx(("x", N, s)) if k == N - 1
                                        else dummy_x)
                    rows["p"].append(combos[b + boff[k, s]])
                    rows["om"].append(1.0 / nscen[k + 1])
                    rows["k0"].append(k == 0)
                    rows["last"].append(k == N - 1)
        self.I = len(rows["om"])
        self.rows = {key: np.array(v) for key, v in rows.items()}
        self.E = ni * (deg + 1) * nx + nx
        self.m = nx + self.I * self.E
        self.q = self.I * len(self.nl)
        self.u_prev = np.asarray(ocp.get("u_prev", np.zeros(nu)), float)
        self.rterm = _named(ocp.get("rterm", {}), un, 0.0)
        self.x0_idx = idx(("x", 0, 0))
        self.u0_idx = idx(("u", 0, 0))
        self._dev = {}

    def _t(self, device):
        """The index and constant tensors on ``device`` (cached)."""
        if device not in self._dev:
            f64 = dict(dtype=torch.float64, device=device)
            r = self.rows
            self._dev[device] = dict(
                node=torch.as_tensor(r["node"], device=device),
                nxt=torch.as_tensor(r["nxt"], device=device),
                coll=torch.as_tensor(r["coll"], device=device),
                u=torch.as_tensor(r["u"], device=device),
                uprev=torch.as_tensor(r["uprev"], device=device),
                eps=torch.as_tensor(r["eps"], device=device),
                term=torch.as_tensor(r["term"], device=device),
                p=torch.as_tensor(r["p"], **f64),
                om=torch.as_tensor(r["om"], **f64),
                k0=torch.as_tensor(r["k0"], device=device),
                last=torch.as_tensor(r["last"], **f64),
                xs=torch.as_tensor(self.xs, **f64),
                us=torch.as_tensor(self.us, **f64),
                pen=torch.as_tensor(self.soft_pen, **f64),
                rterm=torch.as_tensor(self.rterm, **f64),
                uprev0=torch.as_tensor(self.u_prev / self.us, **f64))
        return self._dev[device]

    def functions(self, w, x0):
        """(f (B,), g (B, m), h (B, q)) at scaled decision vectors ``w``
        (B, n) for initial states ``x0`` (B, nx), both float64."""
        t = self._t(w.device)
        B, I, nx, nu = w.shape[0], self.I, self.nx, self.nu
        xs, us, mdl = t["xs"], t["us"], self.model
        xk0 = w[:, t["node"]]                                  # (B, I, nx)
        coll = w[:, t["coll"]].reshape(B, I, self.n_coll, nx)
        u = w[:, t["u"]]
        uprev = torch.where(t["k0"][None, :, None],
                            t["uprev0"].expand(B, I, nu), w[:, t["uprev"]])
        p = t["p"].expand(B, I, -1)
        om = t["om"]

        x_un, u_un = xk0 * xs, u * us
        val = om * mdl.lterm(x_un, u_un, p)
        val = val + t["last"] * om * mdl.mterm(w[:, t["term"]] * xs, p)
        val = val + om * (t["rterm"] * (u - uprev) ** 2).sum(-1)
        eps = w[:, t["eps"]]
        if eps.shape[-1]:
            val = val + (t["pen"] * eps).sum(-1)
        f = val.sum(-1)

        # collocation: point (i, j) of the finite elements; (0, 0) is the
        # interval start, the last stored point the interval end
        deg, C, D = self.deg, self.C, self.D

        def X(i, j):
            if i == 0 and j == 0:
                return xk0
            flat = (j - 1) if i == 0 else (deg + (i - 1) * (deg + 1) + j)
            return coll[:, :, flat]

        res = []
        for i in range(self.ni):
            for j in range(1, deg + 1):
                xp = sum(float(C[r, j]) * X(i, r) for r in range(deg + 1))
                fj = mdl.rhs(X(i, j) * xs, u_un, p) / xs
                res.append(self.h_el * fj - xp)
            xf = sum(float(D[r]) * X(i, r) for r in range(deg + 1))
            x_next = X(i + 1, 0) if i + 1 < self.ni \
                else coll[:, :, self.n_coll - 1]
            res.append(x_next - xf)
        res.append(coll[:, :, self.n_coll - 1] - w[:, t["nxt"]])
        g_inst = torch.cat(res, -1)                            # (B, I, E)
        init = w[:, torch.as_tensor(self.x0_idx, device=w.device)] - x0 / xs
        g = torch.cat([init, g_inst.reshape(B, -1)], -1)

        hs = []
        for j, (name, ubv, is_soft) in enumerate(self.nl):
            v = mdl.nl_cons(name, x_un, u_un, p)
            if is_soft:             # soft constraints come first
                v = v - eps[..., j]
            hs.append(v - ubv)
        h = torch.stack(hs, -1).reshape(B, -1) if hs else w.new_zeros((B, 0))
        return f, g, h
