"""Parametric NLP sensitivities via the implicit function theorem
(PyTorch port of the JAX package's ``differentiator/_nlpdifferentiator.py``).

At a KKT point with the active set fixed (reference
``do_mpc/differentiator/_nlpdifferentiator.py:289-303``),

    [ H    A^T ] [ dw/dp   ]     [ d(grad_L)/dp ]
    [ A    0   ] [ dlam/dp ] = - [ d c_act /dp  ]

where A stacks the equality Jacobian, the active inequality rows and the
active bound unit rows.  The Hessian and Jacobians come from the optimizer's
oracles, the parameter Jacobians from ``torch.func.jacfwd`` over ``p``; the
system is assembled and solved densely on the optimizer's device and in its
dtype.  The active-set detection runs in numpy on the values copied back, so
its thresholds read exactly as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .helper import NLPDifferentiatorSettings, NLPDifferentiatorStatus


class NLPDifferentiator:
    """Differentiates the optimizer's solution map p -> (w*(p), lam*(p)).

    Works for any object exposing the internal oracle interface of
    :class:`~dompc_tpu_torch.controller.MPC` (``_grad_f_fn``, ``_g_fn``,
    ``_h_fn``, ``_jac_g_fn``, ``_jac_h_fn``, ``_hess_fn``, ``_lb_opt_x``,
    ``_ub_opt_x``, and ``_tensor``, numpy to its device and dtype).
    """

    def __init__(self, optimizer, settings: NLPDifferentiatorSettings = None):
        self.opt = optimizer
        self.settings = settings or NLPDifferentiatorSettings()
        self.status = NLPDifferentiatorStatus()

    def _active_sets(self, w, lam, zl, zu):
        """Active bounds/inequalities by primal distance OR dual magnitude
        (reference :347-394 has 'primal' and 'dual' detection; the union
        keeps constraints held active by a significant multiplier when the
        primal sits tol-outside).  Also records strict complementarity:
        entries where both the primal gap and the dual are ~0 make the
        sensitivity set-valued (reference SC check, :606-647)."""
        opt = self.opt
        lb, ub = opt._lb_opt_x, opt._ub_opt_x
        tol = self.settings.active_set_tol
        m = opt.n_opt_lagr
        q = opt._n_ineq
        lam_h = lam[m:m + q]
        prim_lb = np.isfinite(lb) & (w - lb < tol)
        prim_ub = np.isfinite(ub) & (ub - w < tol)
        # the dual threshold is relative to the dual scale of this
        # solution, taken as the mean |dual| over the above-tol subset: one
        # strongly-active constraint with a huge multiplier must not raise
        # the bar enough to deactivate moderately-active ones
        all_d = np.concatenate([np.abs(zl[:len(w)]), np.abs(zu[:len(w)]),
                                np.abs(lam_h)])
        act_d = all_d[all_d > tol]
        dual_scale = max(1.0, float(act_d.mean()) if act_d.size else 0.0)
        dual_thr = np.sqrt(tol) * dual_scale
        act_lb = prim_lb | (zl[:len(w)] > dual_thr)
        act_ub = prim_ub | (zu[:len(w)] > dual_thr)
        hv = opt._h_fn(opt._tensor(w), opt._tensor(opt.opt_p_num)) \
            .detach().to("cpu", torch.float64).numpy()
        prim_h = hv > -tol
        act_h = prim_h | (lam_h > dual_thr)
        weak = (np.any(prim_lb & (zl[:len(w)] <= tol))
                or np.any(prim_ub & (zu[:len(w)] <= tol))
                or np.any(prim_h & (lam_h <= tol)))
        if self.settings.check_SC:
            self.status.SC = not weak
        return act_lb, act_ub, act_h

    def _solve_lse(self, K, rhs):
        """Solve K s = rhs densely.  An exactly singular K (LU's ``info !=
        0``, numpy's ``LinAlgError``) takes the minimum-norm least-squares
        solution through the pseudo-inverse, with numpy ``lstsq``'s default
        cut-off (singular values below eps * max(K.shape) * s_max), unless
        ``lstsq_fallback`` is off."""
        sens, info = torch.linalg.solve_ex(K, rhs)
        if int(info) != 0:
            if not self.settings.lstsq_fallback:
                raise np.linalg.LinAlgError(
                    f"singular KKT matrix (LU info {int(info)})")
            rtol = torch.finfo(K.dtype).eps * max(K.shape)
            sens = torch.linalg.pinv(K, rtol=rtol) @ rhs
        self.status.lse_solved = True
        return sens

    def differentiate(self, w=None, lam=None, pvec=None):
        """Return (dw_dp, dlam_dp) at the optimizer's current solution, as
        float64 numpy arrays."""
        opt = self.opt
        w = np.asarray(opt.opt_x_num if w is None else w, dtype=float)
        lam = np.asarray(opt.lam_g_num if lam is None else lam, dtype=float)
        pvec = np.asarray(opt.opt_p_num if pvec is None else pvec,
                          dtype=float)
        m = opt.n_opt_lagr
        q = opt._n_ineq
        n = w.shape[0]
        n_p = pvec.shape[0]
        zl = np.asarray(getattr(opt, "_zl_warm", np.zeros(n)))[:n]
        zu = np.asarray(getattr(opt, "_zu_warm", np.zeros(n)))[:n]

        act_lb, act_ub, act_h = self._active_sets(w, lam, zl, zu)
        act_b = act_lb | act_ub
        self.active_sets = dict(lb=act_lb, ub=act_ub, h=act_h)

        T = opt._tensor
        wt, pt = T(w), T(pvec)
        lam_g, lam_h = T(lam[:m]), T(lam[m:m + q])
        dev, dt = wt.device, wt.dtype
        act_h_t = torch.as_tensor(np.nonzero(act_h)[0], device=dev)
        act_b_t = torch.as_tensor(np.nonzero(act_b)[0], device=dev)
        n_b = int(act_b_t.numel())
        H = opt._hess_fn(wt, pt, lam_g, lam_h)
        Jg = opt._jac_g_fn(wt, pt)
        Jh = opt._jac_h_fn(wt, pt)[act_h_t] if q \
            else wt.new_zeros((0, n))
        I_act = wt.new_zeros((n_b, n))
        I_act[torch.arange(n_b, device=dev), act_b_t] = 1.0
        A = torch.cat([Jg, Jh, I_act])
        n_act = A.shape[0]

        # parameter derivatives: forward mode in p of the Lagrangian
        # gradient (reverse mode in w)
        def lag_grad_p(p_):
            gl = opt._grad_f_fn(wt, p_)
            gl = gl + torch.func.vjp(lambda ww: opt._g_fn(ww, p_),
                                     wt)[1](lam_g)[0]
            if q:
                gl = gl + torch.func.vjp(lambda ww: opt._h_fn(ww, p_),
                                         wt)[1](lam_h)[0]
            return gl

        jacfwd = torch.func.jacfwd
        # jacfwd can return float64 for a float32 function: back to dt
        dgl_dp = jacfwd(lag_grad_p)(pt).to(dt)
        dg_dp = jacfwd(lambda p_: opt._g_fn(wt, p_))(pt).to(dt)
        dh_dp = jacfwd(lambda p_: opt._h_fn(wt, p_))(pt).to(dt)[act_h_t] \
            if q else wt.new_zeros((0, n_p))
        dc_dp = torch.cat([dg_dp, dh_dp, wt.new_zeros((n_b, n_p))])

        dim = n + n_act
        K = wt.new_zeros((dim, dim))
        K[:n, :n] = H
        K[:n, n:] = A.T
        K[n:, :n] = A
        rhs = -torch.cat([dgl_dp, dc_dp])
        self.K_dim = dim

        if self.settings.check_LICQ:
            self.status.LICQ = bool(int(torch.linalg.matrix_rank(
                A, atol=1e-8, rtol=0.0)) == n_act)
        if self.settings.check_rank:
            self.status.full_rank = bool(int(torch.linalg.matrix_rank(
                K, atol=1e-8, rtol=0.0)) == dim)
        sens = self._solve_lse(K, rhs)
        if self.settings.track_residuals:
            self.status.residuals = float((K @ sens - rhs).abs().max())
        sens = sens.to("cpu", torch.float64).numpy()
        return sens[:n], sens[n:]


class DoMPCDifferentiator(NLPDifferentiator):
    """Adapter for MPC instances (reference :710-870): rescales the primal
    sensitivities to physical units and exposes named queries."""

    def differentiate(self, **kw):
        dw_dp, dlam_dp = super().differentiate(**kw)
        scal = self.opt.opt_x_scaling
        self.dx_dp_num = dw_dp * scal[:, None]
        self.dlam_dp_num = dlam_dp
        return self.dx_dp_num, self.dlam_dp_num

    @property
    def sens_num(self):
        class _Q:
            def __init__(self, outer):
                self.outer = outer

            def __getitem__(self, key):
                assert key[0] == "dxdp"
                return self.outer.dx_dp_num
        return _Q(self)

    def du0_dx0(self):
        """Sensitivity of the first input w.r.t. the measured state, the
        quantity used for explicit-MPC style analysis."""
        opt = self.opt
        dx_dp, _ = self.differentiate()
        u_sl = opt.layout.sl(("u", 0, 0))
        x0_sl = opt._p_sl["x0"]
        return dx_dp[u_sl, x0_sl]
