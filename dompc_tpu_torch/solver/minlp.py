"""Batched branch-and-bound for mixed-integer NMPC (PyTorch port of the JAX
package's ``solver/minlp.py``).

The tree search stays on the host; the node relaxations are solved in
batches: every frontier expansion solves up to ``batch_width`` node
relaxations as ONE call of the batch-first interior-point solver, the
nodes being rows of the batch.  Node relaxations differ from the root
problem only in the bound values on the integer entries of the decision
vector, so one solver built with ``dynamic_bounds=True`` serves every node,
with ``lb_dyn``/``ub_dyn`` of shape (nodes, n).  Fixed integers (lb == ub
after branching) are kept as an epsilon-box so the log barrier stays
defined; the incumbent's integer entries are snapped to the exact integers
on extraction.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from .ipm import IPMSettings


@dataclass
class BnBResult:
    w: np.ndarray          # incumbent decision vector (integral entries)
    f: float               # incumbent objective
    success: bool          # an integral incumbent was found
    n_nodes: int           # relaxations solved (excluding the root)
    gap: float             # |best remaining lower bound - incumbent|
    lam: np.ndarray | None = None
    zl: np.ndarray | None = None
    zu: np.ndarray | None = None


def _row(x):
    """A batch-of-one solution field (or a 1-D one) as a host float64 row."""
    if torch.is_tensor(x):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=float).reshape(-1)


class BranchAndBound:
    """Best-first branch-and-bound over the integer entries of an MPC
    decision vector.

    ``opt`` is the set-up MPC, whose ``_make_solver`` builds the node
    solver (uncondensed BBD KKT, per-call bounds; its static bounds are the
    root's) and whose ``_tensor`` puts host rows on its device.
    ``int_idx`` are indices into the decision vector, ``int_scale`` the
    per-entry scaling (integrality is imposed on ``w * scale``).
    """

    def __init__(self, opt, int_idx, int_scale, tol=1e-8, max_iter=150,
                 batch_width=8, max_nodes=64, int_tol=1e-5, gap_tol=1e-8,
                 eps_fix=1e-6):
        self.int_idx = np.asarray(int_idx, int)
        self.int_scale = np.asarray(int_scale, float)
        self.batch_width = int(batch_width)
        self.max_nodes = int(max_nodes)
        self.int_tol = float(int_tol)
        self.gap_tol = float(gap_tol)
        self.eps_fix = float(eps_fix)
        self._tensor = opt._tensor
        self._solve = opt._make_solver(
            IPMSettings(tol=tol, max_iter=max_iter, reg_retries=2,
                        use_soc=False, do_polish=False),
            "bbd", dynamic_bounds=True)
        self._lb0, self._ub0 = self._solve.lb, self._solve.ub
        if not (np.all(np.isfinite(self._lb0[self.int_idx]))
                and np.all(np.isfinite(self._ub0[self.int_idx]))):
            raise ValueError(
                "branch-and-bound needs finite bounds on every integer "
                "input (set mpc.bounds for them)")

    def _node_solve(self, w0, pvec, lam0, zl0, zu0, lbs, ubs):
        """One frontier expansion: the root's primal-dual point broadcast
        over the node rows, each with its own bound values."""
        k = lbs.shape[0]

        def rows(x):
            return self._tensor(x)[None].expand(k, -1)
        return self._solve(rows(w0), rows(pvec), rows(lam0), 1e-2,
                           rows(zl0), rows(zu0), lb_dyn=self._tensor(lbs),
                           ub_dyn=self._tensor(ubs))

    # -- host-side tree search ------------------------------------------
    def _fractionality(self, w):
        vals = w[self.int_idx] * self.int_scale
        return np.abs(vals - np.round(vals))

    def refine(self, pvec, root) -> BnBResult:
        """Run B&B below an already-solved root relaxation.

        ``root``: the IPMSolution of the continuous relaxation (a batch of
        one, as ``MPC.solve`` leaves it, or 1-D fields).  Returns the
        incumbent; ``success=False`` only when no integral point was found
        within the node budget.
        """
        w_root = _row(root.w)
        lam_root, zl_root, zu_root = (_row(root.lam), _row(root.zl),
                                      _row(root.zu))
        f_root = float(_row(root.f)[0])
        frac = self._fractionality(w_root)
        if frac.max(initial=0.0) <= self.int_tol:
            return BnBResult(w=self._snap(w_root), f=f_root, success=True,
                             n_nodes=0, gap=0.0, lam=lam_root, zl=zl_root,
                             zu=zu_root)

        inc_f = np.inf
        inc = None
        n_nodes = 0
        counter = 0  # heap tiebreaker
        # heap entries: (parent_bound, counter, lb, ub)
        frontier = []
        for lbn, ubn in self._branch(w_root, self._lb0.copy(),
                                     self._ub0.copy(), frac):
            frontier.append((f_root, counter, lbn, ubn))
            counter += 1
        heapq.heapify(frontier)

        while frontier and n_nodes < self.max_nodes:
            batch = []
            while frontier and len(batch) < self.batch_width:
                bound, _, lbn, ubn = heapq.heappop(frontier)
                if bound >= inc_f - self.gap_tol:
                    continue  # pruned by incumbent
                batch.append((bound, lbn, ubn))
            if not batch:
                break
            sols = self._node_solve(
                w_root, pvec, lam_root, zl_root, zu_root,
                np.stack([b[1] for b in batch]),
                np.stack([b[2] for b in batch]))
            n_nodes += len(batch)

            def host(x):
                return x.detach().to("cpu", torch.float64).numpy()
            ws, fs = host(sols.w), host(sols.f)
            oks = sols.success.cpu().numpy()
            lams, zls, zus = host(sols.lam), host(sols.zl), host(sols.zu)
            for i, (bound, lbn, ubn) in enumerate(batch):
                if not oks[i]:
                    continue  # infeasible / non-converged: prune
                if fs[i] >= inc_f - self.gap_tol:
                    continue
                frac = self._fractionality(ws[i])
                if frac.max(initial=0.0) <= self.int_tol:
                    inc_f = fs[i]
                    inc = (self._snap(ws[i]), lams[i], zls[i], zus[i])
                    continue
                for lbc, ubc in self._branch(ws[i], lbn, ubn, frac):
                    heapq.heappush(frontier, (fs[i], counter, lbc, ubc))
                    counter += 1
        gap = frontier[0][0] - inc_f if frontier and inc is not None \
            else 0.0
        if inc is None:
            return BnBResult(w=w_root, f=f_root, success=False,
                             n_nodes=n_nodes, gap=np.inf)
        w_inc, lam_inc, zl_inc, zu_inc = inc
        return BnBResult(w=w_inc, f=float(inc_f), success=True,
                         n_nodes=n_nodes,
                         gap=float(max(gap, 0.0)) if frontier else 0.0,
                         lam=lam_inc, zl=zl_inc, zu=zu_inc)

    def _snap(self, w):
        w = np.array(w, float)
        vals = np.round(w[self.int_idx] * self.int_scale)
        w[self.int_idx] = vals / self.int_scale
        return w

    def _branch(self, w, lbn, ubn, frac):
        """Two children splitting the most fractional integer entry."""
        j = int(np.argmax(frac))
        gj = self.int_idx[j]
        sc = self.int_scale[j]
        v = w[gj] * sc
        lo_int, hi_int = np.floor(v), np.ceil(v)
        eps = self.eps_fix * max(1.0, abs(v)) / sc
        children = []
        # down child: u_j <= floor(v)
        lbd, ubd = lbn.copy(), ubn.copy()
        ubd[gj] = lo_int / sc
        if ubd[gj] - lbd[gj] < eps:          # collapsed: epsilon-box
            lbd[gj] = ubd[gj] - eps
        if lbd[gj] <= ubd[gj]:
            children.append((lbd, ubd))
        # up child: u_j >= ceil(v)
        lbu, ubu = lbn.copy(), ubn.copy()
        lbu[gj] = hi_int / sc
        if ubu[gj] - lbu[gj] < eps:
            ubu[gj] = lbu[gj] + eps
        if lbu[gj] <= ubu[gj]:
            children.append((lbu, ubu))
        return children
