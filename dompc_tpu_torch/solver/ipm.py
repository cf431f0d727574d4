"""Primal-dual interior-point NLP solver (PyTorch port).

Counterpart of the JAX package's ``solver/ipm.py`` on its default path:
Fiacco-McCormick barrier loop with exact-Hessian primal-dual Newton steps,
the Wächter-Biegler (theta, phi) filter line search, second-order
correction, the regularization ladder capped at ``prox_max``, the dual
trust region ``dual_cap``, select-gated feasibility restoration
(``use_resto``), the best-iterate watchdog and the active-set Newton
polish.

Problem form:

    min_w f(w, p)   s.t.  g(w, p) = 0,  h(w, p) <= 0,  lb <= w <= ub

The JAX ``lax.while_loop`` becomes a Python loop, and ``_cond_any``
(skip a branch when no element needs it) a Python ``if`` on the
predicate: the same zero-trip semantics.  The state keeps the JAX
solver's select-based arithmetic (``torch.where``, no per-element Python
branching), so a leading batch axis can be added later; this port
solves one instance at a time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function as _range

from .._config import resolve_device, resolve_dtype


@dataclass(frozen=True)
class IPMSettings:
    """The JAX package's ``IPMSettings`` fields that the ported path reads,
    with the same defaults (see there for the reasoning behind each), plus
    those of ``_UNPORTED``.  The RTI knobs, ``lam_init_max``,
    ``refit_delta`` and ``debug`` come with the code paths that read
    them."""
    tol: float = 1e-8
    tol_loop: float | None = None
    max_iter: int = 200
    mu_init: float = 1e-1
    mu_min_factor: float = 0.1
    kappa_eps: float = 10.0
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    bound_push: float = 1e-2
    bound_frac: float = 1e-2
    slack_min: float = 1e-8
    z_init: float = 1.0
    ls_max: int = 25
    globalization: str = "filter"
    filter_size: int = 16
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    eta_phi: float = 1e-8
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_switch: float = 1.0
    gamma_alpha: float = 0.05
    use_resto: bool = True
    resto_delta: float = 1e6
    delta_reg: float = 1e-8
    delta_cons: float = 1e-11
    cold_dual_init: bool = False
    dual_cap: float = 1e2
    prox_max: float = 1e4
    s_max: float = 100.0
    reg_retries: int = 5
    use_soc: bool = True
    do_polish: bool = True
    rti_iters: int = 0
    dual_refit: bool = False
    n_refine_kkt: int = 0


# settings whose non-default values select code paths not ported yet
_UNPORTED = {"rti_iters": 0, "globalization": "filter",
             "cold_dual_init": False, "dual_refit": False,
             "n_refine_kkt": 0, "tol_loop": None}


def ipm_settings_from(st, **overrides) -> "IPMSettings":
    """Build IPMSettings from an MPC settings object (the ``solver_*``
    fields and IPOPT-style ``nlpsol_opts`` keys, as in the JAX package)."""
    kw = dict(
        tol=getattr(st, "solver_tol", 1e-8),
        tol_loop=getattr(st, "solver_tol_loop", None),
        max_iter=getattr(st, "solver_max_iter", 200),
        mu_init=getattr(st, "solver_mu_init", 1e-1),
        reg_retries=getattr(st, "solver_reg_retries", 5),
        use_soc=getattr(st, "solver_use_soc", True),
        do_polish=getattr(st, "solver_do_polish", True),
        ls_max=getattr(st, "solver_ls_max", 25),
        mu_min_factor=getattr(st, "solver_mu_min_factor", 0.1),
        rti_iters=getattr(st, "solver_rti_iters", 0),
        globalization=getattr(st, "solver_globalization", "filter"),
        n_refine_kkt=getattr(st, "solver_n_refine_kkt", 0),
    )
    ipopt_map = {
        "ipopt.tol": ("tol", float),
        "ipopt.max_iter": ("max_iter", int),
        "ipopt.mu_init": ("mu_init", float),
        "ipopt.max_soc": ("use_soc", lambda v: bool(int(v))),
    }
    silent_ok = {"ipopt.print_level", "ipopt.sb", "print_time",
                 "ipopt.linear_solver", "ipopt.warm_start_init_point",
                 "expand", "ipopt.output_file"}
    for key, val in getattr(st, "nlpsol_opts", {}).items():
        if key in ipopt_map:
            name, conv = ipopt_map[key]
            kw[name] = conv(val)
        elif key not in silent_ok:
            import warnings as _warnings
            _warnings.warn(
                f"nlpsol_opts key {key!r} has no equivalent in the "
                "interior-point solver and is ignored "
                f"(mapped keys: {sorted(ipopt_map)}).", stacklevel=2)
    kw.update(overrides)
    return IPMSettings(**kw)


class IPMState(NamedTuple):
    w: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor      # equality multipliers [g; h+s]
    zl: torch.Tensor       # lower bound duals for [w; s]
    zu: torch.Tensor       # upper bound duals for [w; s]
    mu: torch.Tensor
    it: int
    converged: torch.Tensor
    kkt_err: torch.Tensor
    prox: torch.Tensor     # adaptive Levenberg damping
    best: tuple            # best-iterate watchdog (w, s, lam, zl, zu)
    best_err: torch.Tensor
    filt_th: torch.Tensor  # Wächter-Biegler filter entries
    filt_ph: torch.Tensor
    filt_n: torch.Tensor
    th_max: torch.Tensor
    th_min: torch.Tensor


class IPMSolution(NamedTuple):
    w: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    f: torch.Tensor
    kkt_err: torch.Tensor
    iterations: int
    success: torch.Tensor


_TINY = 1e-30  # safe positive floor that survives float32


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _cond_any(pred, true_fn, false_val):
    """Run ``true_fn`` only when some element's predicate holds (the JAX
    package's zero-trip ``while_loop``, here a host-side ``if``)."""
    return true_fn() if bool(torch.as_tensor(pred).any()) else false_val


def _maxabs(x):
    """max |x| with 0 for an empty tensor (jnp ``initial=0.0``)."""
    return x.abs().amax() if x.numel() else x.new_zeros(())


def _all_finite(*xs):
    out = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        out = out & torch.isfinite(x).all()
    return out


def make_ipm_solver(
    f: Callable, g: Callable, h: Callable,
    lb, ub, n_eq: int, n_ineq: int,
    settings: IPMSettings = IPMSettings(),
    kkt_solve: Optional[Callable] = None,
    hess_fn: Optional[Callable] = None,
    grad_f_fn: Optional[Callable] = None,
    jac_g_fn: Optional[Callable] = None,
    jac_h_fn: Optional[Callable] = None,
    structured_solve: Optional[tuple] = None,
    dynamic_bounds: bool = False,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
):
    """Build a single-instance solver
    ``solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None) -> IPMSolution``.

    f/g/h take (w, p) tensors.  ``lb/ub`` are numpy arrays (may contain
    +-inf), moved to ``device`` in ``dtype``.  ``structured_solve`` is a
    ``(prepare, solve)`` pair: ``prepare(w, p, lam_g, lam_h, sig_w,
    inv_sig_s)`` once per Newton step, ``solve(ctx, r_dw, r_g, r_h_mod,
    delta) -> (dw, dlam_g, dlam_h)`` for every right-hand side.  Without
    it the KKT system is solved densely.  ``device`` and ``dtype`` default
    to the environment's choice (``DOMPC_TPU_PLATFORM``, ``DOMPC_TPU_X64``):
    CUDA unless the CPU is asked for.
    """
    st = settings
    for name, default in _UNPORTED.items():
        if getattr(st, name) != default:
            raise NotImplementedError(
                f"IPM setting {name}={getattr(st, name)!r} is not ported "
                f"yet (only the default {default!r})")
    if dynamic_bounds:
        raise NotImplementedError("dynamic_bounds is not ported yet")
    device = resolve_device() if device is None else torch.device(device)
    dtype = resolve_dtype() if dtype is None else dtype

    def T(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    lb = T(np.asarray(lb, dtype=float))
    ub = T(np.asarray(ub, dtype=float))
    n = lb.shape[0]
    m, q = n_eq, n_ineq
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    ones_q = torch.ones((q,), dtype=torch.bool, device=device)
    zeros_qb = torch.zeros((q,), dtype=torch.bool, device=device)
    empty = torch.zeros((0,), dtype=dtype, device=device)
    inf = float("inf")

    grad_f = grad_f_fn if grad_f_fn is not None else torch.func.grad(f)
    jac_g = jac_g_fn if jac_g_fn is not None else (
        torch.func.jacfwd(g) if m else None)
    jac_h = jac_h_fn if jac_h_fn is not None else (
        torch.func.jacfwd(h) if q else None)

    if hess_fn is None:
        def lagrangian(w, p, lam_g, lam_h):
            val = f(w, p)
            if m:
                val = val + torch.dot(lam_g, g(w, p))
            if q:
                val = val + torch.dot(lam_h, h(w, p))
            return val
        hess_fn = torch.func.hessian(lagrangian)

    def eval_all(w, p):
        return (g(w, p) if m else empty), (h(w, p) if q else empty)

    # Jacobian-vector products (used instead of materialized Jacobians
    # wherever possible, and exclusively in structured mode)
    def jgT_mv(w, p, lam):
        if not m:
            return torch.zeros_like(w)
        return torch.func.vjp(lambda ww: g(ww, p), w)[1](lam)[0]

    def jhT_mv(w, p, nu):
        if not q:
            return torch.zeros_like(w)
        return torch.func.vjp(lambda ww: h(ww, p), w)[1](nu)[0]

    def jg_mv(w, p, dx):
        if not m:
            return empty
        return torch.func.jvp(lambda ww: g(ww, p), (w,), (dx,))[1]

    def jh_mv(w, p, dx):
        if not q:
            return empty
        return torch.func.jvp(lambda ww: h(ww, p), (w,), (dx,))[1]

    # -- barrier helpers over the combined (w bounds, s >= 0) --------------
    def dist_l(w, s):
        return torch.where(has_lb, w - lb, 1.0), s  # slack lower bound is 0

    def dist_u(w):
        return torch.where(has_ub, ub - w, 1.0)

    def barrier_value(w, s, p, mu):
        val = f(w, p)
        dl = torch.where(has_lb, w - lb, 1.0)
        du = torch.where(has_ub, ub - w, 1.0)
        val = val - mu * torch.sum(torch.where(has_lb, torch.log(dl), 0.0))
        val = val - mu * torch.sum(torch.where(has_ub, torch.log(du), 0.0))
        if q:
            val = val - mu * torch.sum(torch.log(s))
        return val

    def constraint_violation(gv, hv, s):
        vio = torch.sum(torch.abs(gv)) if m else T(0.0)
        if q:
            vio = vio + torch.sum(torch.abs(hv + s))
        return vio

    # -- KKT error ---------------------------------------------------------
    def point_evals(w, lam, p):
        """(gradient, residuals, J^T lam) shared by the KKT-error check and
        the Newton step at the same point."""
        gf = grad_f(w, p)
        gv, hv = eval_all(w, p)
        jtl = jgT_mv(w, p, lam[:m]) + jhT_mv(w, p, lam[m:])
        return gf, gv, hv, jtl

    mask_l = torch.cat([has_lb, ones_q])
    mask_zu = torch.cat([has_ub, zeros_qb])

    def kkt_residuals(w, s, lam, zl, zu, p, pre=None):
        """Mu-independent residual summary (one evaluation serves
        err_mu / err_0 / err_{mu_new})."""
        gf, gv, hv, jtl = pre if pre is not None else point_evals(
            w, lam, p)
        r_dw = gf + jtl
        r_dw = r_dw - torch.where(has_lb, zl[:n], 0.0) \
            + torch.where(has_ub, zu[:n], 0.0)
        r_ds = (lam[m:] - zl[n:]) if q else empty
        r_p = torch.cat([gv, hv + s])
        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        comp_l = torch.cat([torch.where(has_lb, dl_w * zl[:n], 0.0),
                            dl_s * zl[n:]])
        comp_u = torch.where(has_ub, du_w * zu[:n], 0.0)
        z_sum = torch.sum(torch.abs(zl)) + torch.sum(torch.abs(zu))
        lam_sum = torch.sum(torch.abs(lam))
        denom = n + q + m
        s_d = torch.clamp((lam_sum + z_sum) / max(denom, 1),
                          min=st.s_max) / st.s_max
        s_c = torch.clamp(z_sum / max(n + q, 1), min=st.s_max) / st.s_max
        err_d = _maxabs(torch.cat([r_dw, r_ds])) / s_d
        err_p = _maxabs(r_p)
        return err_d, err_p, comp_l, comp_u, s_c

    def err_from(res, mu):
        err_d, err_p, comp_l, comp_u, s_c = res
        c_l = torch.where(mask_l, comp_l - mu, 0.0)
        c_u = torch.where(has_ub, comp_u - mu, 0.0)
        err_c = torch.maximum(_maxabs(c_l), _maxabs(c_u)) / s_c
        return torch.maximum(torch.maximum(err_d, err_p), err_c)

    def kkt_error(w, s, lam, zl, zu, p, mu):
        return err_from(kkt_residuals(w, s, lam, zl, zu, p), mu)

    # -- dense KKT solve ---------------------------------------------------
    def dense_kkt(Hw, Sig_w, Jg, Jh, inv_sig_s, r_dw, r_g, r_h_mod, delta):
        dim = n + m + q
        K = torch.zeros((dim, dim), dtype=dtype, device=device)
        K[:n, :n] = Hw + torch.diag(Sig_w + delta)
        if m:
            K[:n, n:n + m] = Jg.T
            K[n:n + m, :n] = Jg
        if q:
            K[:n, n + m:] = Jh.T
            K[n + m:, :n] = Jh
            K[n + m:, n + m:] = -torch.diag(inv_sig_s)
        K[n:, n:] -= st.delta_cons * torch.eye(m + q, dtype=dtype,
                                               device=device)
        # solve_ex: singular K gives non-finite values (rejected by the
        # callers), as with jnp.linalg.solve, instead of raising
        sol = torch.linalg.solve_ex(K, torch.cat([-r_dw, -r_g, -r_h_mod]))[0]
        return sol[:n], sol[n:n + m], sol[n + m:]

    solve_kkt = kkt_solve if kkt_solve is not None else dense_kkt

    # -- one Newton iteration at fixed mu ----------------------------------
    def newton_step(w, s, lam, zl, zu, p, mu, prox, pre):
        lam_g, lam_h = lam[:m], lam[m:]
        gf, gv, hv, jtl = pre

        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        dl_w = torch.clamp(dl_w, min=_TINY)
        du_w = torch.clamp(du_w, min=_TINY)
        dl_s = torch.clamp(dl_s, min=_TINY)

        sig_w = torch.where(has_lb, zl[:n] / dl_w, 0.0) \
            + torch.where(has_ub, zu[:n] / du_w, 0.0)
        sig_s = zl[n:] / dl_s

        # barrier-gradient form of the dual residual
        r_dw = gf + jtl \
            - torch.where(has_lb, mu / dl_w, 0.0) \
            + torch.where(has_ub, mu / du_w, 0.0)
        r_ds = lam_h - mu / dl_s if q else empty
        r_g = gv
        r_h = hv + s
        inv_sig_s = 1.0 / torch.clamp(sig_s, min=_TINY) if q else empty
        r_h_mod = r_h - r_ds * inv_sig_s

        if structured_solve is not None:
            # derivatives + assembly once per Newton step; the retry ladder
            # and the second-order correction reuse the assembled system
            s_prepare, s_solve = structured_solve
            with _range("kkt.prepare"):
                kkt_ctx = s_prepare(w, p, lam_g, lam_h, sig_w, inv_sig_s)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                with _range("kkt.solve"):
                    return s_solve(kkt_ctx, r_dw_, r_g_, r_h_mod_, T(delta))

            def lag_grad(ww):
                return (grad_f(ww, p) + jgT_mv(ww, p, lam_g)
                        + jhT_mv(ww, p, lam_h))

            def hvp(dx):
                # Lagrangian Hessian-vector product via jvp of the gradient
                return torch.func.jvp(lag_grad, (w,), (dx,))[1]
        else:
            Jg = jac_g(w, p) if m else empty.reshape(0, n)
            Jh = jac_h(w, p) if q else empty.reshape(0, n)
            Hw = hess_fn(w, p, lam_g, lam_h)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                return solve_kkt(Hw, sig_w, Jg, Jh, inv_sig_s, r_dw_, r_g_,
                                 r_h_mod_, T(delta))

            def hvp(dx):
                return Hw @ dx

        def do_solve(delta):
            return do_solve_rhs(r_dw, r_g, r_h_mod, delta)

        rhs_norm = torch.maximum(torch.maximum(_maxabs(r_dw), _maxabs(r_g)),
                                 _maxabs(r_h_mod)) + 1e-12

        def step_residual(step, delta, Hd):
            dw_, dg_, dh_ = step
            res_w = (Hd + (sig_w + delta) * dw_ + r_dw
                     + jgT_mv(w, p, dg_) + jhT_mv(w, p, dh_))
            out = _maxabs(res_w)
            if m:
                res_g = jg_mv(w, p, dw_) - st.delta_cons * dg_ + r_g
                out = torch.maximum(out, _maxabs(res_g))
            if q:
                res_h = jh_mv(w, p, dw_) - inv_sig_s * dh_ \
                    - st.delta_cons * dh_ + r_h_mod
                out = torch.maximum(out, _maxabs(res_h))
            return out

        def need_retry(step, delta):
            """Non-finite, wrong curvature, or an inaccurate linear solve
            (inexact-Newton acceptance: a modest relative residual still
            yields a productive step)."""
            dw_ = step[0]
            bad = ~_all_finite(*step)
            Hd = hvp(dw_)
            curv = torch.dot(dw_, Hd) + torch.sum((sig_w + delta) * dw_ * dw_)
            wrong_curv = curv < -1e-10 * (1.0 + torch.dot(dw_, dw_))
            inaccurate = step_residual(step, delta, Hd) > 1e-2 * rhs_norm
            return bad | wrong_curv | inaccurate

        # regularization ladder: escalate the primal regularization while
        # the step is bad; rung deltas are capped at prox_max.  A rung that
        # finds the step good ends the ladder: every later rung would test
        # the same step and skip as well.
        step = do_solve(prox)
        prev_delta = prox
        for mult in (10.0, 1e2, 1e3, 1e5, 1e7)[:st.reg_retries]:
            if not bool(need_retry(step, prev_delta)):
                break
            delta = torch.clamp(torch.clamp(prox, min=1e-8) * mult,
                                max=st.prox_max)
            step = do_solve(delta)
            prev_delta = delta

        dw, dlam_g, dlam_h = step
        # non-finite guard: zero the step and escalate the Levenberg prox
        step_ok = _all_finite(dw, dlam_g, dlam_h)
        dw = torch.where(step_ok, dw, 0.0)
        dlam_g = torch.where(step_ok, dlam_g, 0.0)
        dlam_h = torch.where(step_ok, dlam_h, 0.0)
        prev_delta = torch.where(step_ok, prev_delta,
                                 torch.clamp(prox, min=1e-8) * 100.0)

        def recover(dw_, dlam_g_, dlam_h_, r_h_used):
            ds_ = -(r_h_used + jh_mv(w, p, dw_)) if q else empty
            dlam_ = torch.cat([dlam_g_, dlam_h_])
            dzl_w = torch.where(
                has_lb, _safe_div(mu - zl[:n] * dl_w, dl_w)
                - _safe_div(zl[:n] * dw_, dl_w), 0.0)
            dzl_s = _safe_div(mu - zl[n:] * dl_s, dl_s) \
                - _safe_div(zl[n:] * ds_, dl_s) if q else empty
            dzu_w = torch.where(
                has_ub, _safe_div(mu - zu[:n] * du_w, du_w)
                + _safe_div(zu[:n] * dw_, du_w), 0.0)
            return (dw_, ds_, dlam_, torch.cat([dzl_w, dzl_s]),
                    torch.cat([dzu_w, torch.zeros_like(dzl_s)]))

        def resolve_soc(alpha):
            """Second-order correction: re-solve with the constraint value
            at the trial point."""
            w_t = w + alpha * dw
            gv_t, hv_t = eval_all(w_t, p)
            r_g_soc = alpha * r_g + gv_t
            r_h_soc = alpha * r_h + hv_t + (
                s + alpha * (-(r_h + jh_mv(w, p, dw))) if q else empty)
            r_h_mod_soc = r_h_soc - r_ds * inv_sig_s if q else empty
            dw2, dg2, dh2 = do_solve_rhs(r_dw, r_g_soc, r_h_mod_soc,
                                         prev_delta)
            return recover(dw2, dg2, dh2, r_h_soc)

        def resolve_resto():
            """Feasibility-restoration direction: with the proximal weight
            dominant the KKT system returns the minimum-norm step onto the
            linearized constraints."""
            dwr, dgr2, dhr2 = do_solve_rhs(torch.zeros_like(r_dw), r_g, r_h,
                                           st.resto_delta)
            return recover(dwr, dgr2, dhr2, r_h)

        return recover(dw, dlam_g, dlam_h, r_h) + (resolve_soc, prev_delta,
                                                   resolve_resto)

    # -- fraction to boundary ----------------------------------------------
    def max_alpha(x, dx, dist, active):
        ratio = torch.where(active & (dx < 0),
                            -dist / torch.where(dx == 0, -1.0, dx), inf)
        out = torch.ones((), dtype=dtype, device=device)
        return torch.minimum(out, ratio.amin()) if ratio.numel() else out

    def dual_alpha(zl, zu, dzl, dzu, mu):
        tau = torch.clamp(1.0 - mu, min=st.tau_min)
        a_d = max_alpha(zl, dzl, tau * zl, mask_l)
        return torch.minimum(a_d, max_alpha(zu, dzu, tau * zu, mask_zu))

    def fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu, mu):
        tau = torch.clamp(1.0 - mu, min=st.tau_min)
        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        a_p = max_alpha(w, dw, tau * dl_w, has_lb)
        a_p = torch.minimum(a_p, max_alpha(w, -dw, tau * du_w, has_ub))
        if q:
            a_p = torch.minimum(a_p, max_alpha(s, ds, tau * dl_s, ones_q))
        return a_p, dual_alpha(zl, zu, dzl, dzu, mu)

    # -- main loop ----------------------------------------------------------
    slots = torch.arange(st.filter_size, device=device)

    def take_step(stt, p, pre, res0, err_mu):
        """One globalized iteration from a non-converged state."""
        w, s, lam, zl, zu, mu = stt.w, stt.s, stt.lam, stt.zl, stt.zu, stt.mu
        # barrier update when the inner problem is solved
        shrink = err_mu <= st.kappa_eps * mu
        mu_new = torch.where(
            shrink,
            torch.clamp(torch.minimum(st.kappa_mu * mu, mu ** st.theta_mu),
                        min=st.tol * st.mu_min_factor),
            mu)
        # filter reset on barrier decrease (W-B reinitialize)
        mu_dec = mu_new < mu
        filt_th0 = torch.where(mu_dec, inf, stt.filt_th)
        filt_ph0 = torch.where(mu_dec, inf, stt.filt_ph)
        filt_n0 = torch.where(mu_dec, 0, stt.filt_n)

        with _range("ipm.newton"):
            (dw, ds, dlam, dzl, dzu, resolve_soc, delta_used,
             resolve_resto) = newton_step(w, s, lam, zl, zu, p, mu_new,
                                          stt.prox, pre)
        # dual trust region: primal acceptance cannot see multiplier
        # explosions, so bound them here
        dl_norm = _maxabs(dlam)
        l_norm = _maxabs(lam)
        dlam = dlam * torch.clamp(st.dual_cap * (1.0 + l_norm)
                                  / torch.clamp(dl_norm, min=_TINY), max=1.0)
        a_p, a_d = fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu,
                                        mu_new)
        err_ref = err_from(res0, mu_new)

        def kkt_decrease(alpha, dw_, ds_, dlam_, dzl_, dzu_, a_d_):
            err_t = kkt_error(w + alpha * dw_, s + alpha * ds_,
                              lam + alpha * dlam_, zl + a_d_ * dzl_,
                              zu + a_d_ * dzu_, p, mu_new)
            return torch.isfinite(err_t) & (err_t < 0.99 * err_ref)

        theta_k = constraint_violation(pre[1], pre[2], s)
        phi_k = barrier_value(w, s, p, mu_new)

        def gphi_dot(dw_, ds_):
            """Directional derivative of the barrier objective."""
            dlw_, dls_ = dist_l(w, s)
            duw_ = dist_u(w)
            gphi_w = pre[0] \
                - torch.where(has_lb, mu_new / torch.clamp(dlw_, min=_TINY),
                              0.0) \
                + torch.where(has_ub, mu_new / torch.clamp(duw_, min=_TINY),
                              0.0)
            out = torch.dot(gphi_w, dw_)
            if q:
                out = out + torch.dot(
                    -mu_new / torch.clamp(dls_, min=_TINY), ds_)
            return out

        def accept_fn(alpha, dw_, ds_, gphi_d_):
            """W-B acceptance: acceptable to the filter AND either (f-type:
            switching holds -> Armijo on phi) or (h-type: sufficient
            decrease in theta or phi).  Returns (ok, f_type)."""
            w_t = w + alpha * dw_
            s_t = s + alpha * ds_
            phi_t = barrier_value(w_t, s_t, p, mu_new)
            gv_t, hv_t = eval_all(w_t, p)
            th_t = constraint_violation(gv_t, hv_t, s_t)
            fil_ok = torch.all(
                (th_t <= (1.0 - st.gamma_theta) * filt_th0)
                | (phi_t <= filt_ph0 - st.gamma_phi * filt_th0))
            sw = (gphi_d_ < 0) & (theta_k <= stt.th_min) & (
                alpha * (-gphi_d_) ** st.s_phi
                > st.delta_switch * theta_k ** st.s_theta)
            armijo = phi_t <= phi_k + st.eta_phi * alpha * gphi_d_
            h_ok = (th_t <= (1.0 - st.gamma_theta) * theta_k) \
                | (phi_t <= phi_k - st.gamma_phi * theta_k)
            ok = torch.isfinite(phi_t) & torch.isfinite(th_t) \
                & (th_t <= stt.th_max) & fil_ok \
                & torch.where(sw, armijo, h_ok)
            return ok, sw & armijo

        # full step if acceptable; else one second-order correction; else
        # backtracking.  KKT-error decrease is an OR-acceptance that counts
        # as f-type; it only matters when the filter test is not already
        # an f-type acceptance.
        acc0, ft0 = accept_fn(a_p, dw, ds, gphi_dot(dw, ds))
        kd0 = torch.ones_like(acc0) if bool(acc0 & ft0) else \
            kkt_decrease(a_p, dw, ds, dlam, dzl, dzu, a_d)
        ok_full = acc0 | kd0
        f_type = ft0 | kd0

        def do_soc():
            dw2, ds2, dlam2, dzl2, dzu2 = resolve_soc(a_p)
            a_p2, a_d2 = fraction_to_boundary(w, s, dw2, ds2, zl, zu, dzl2,
                                              dzu2, mu_new)
            kd2 = kkt_decrease(a_p2, dw2, ds2, dlam2, dzl2, dzu2, a_d2)
            acc2, ft2 = accept_fn(a_p2, dw2, ds2, gphi_dot(dw2, ds2))
            return (acc2 | kd2, ft2 | kd2, dw2, ds2, dlam2, dzl2, dzu2,
                    a_p2, a_d2)

        no_soc = (torch.zeros_like(ok_full), torch.ones_like(ok_full), dw,
                  ds, dlam, dzl, dzu, a_p, a_d)
        if st.use_soc:
            (soc_ok, soc_ft, dw2, ds2, dlam2, dzl2, dzu2, a_p2,
             a_d2) = _cond_any(~ok_full, do_soc, no_soc)
        else:
            (soc_ok, soc_ft, dw2, ds2, dlam2, dzl2, dzu2, a_p2,
             a_d2) = no_soc
        use_soc = (~ok_full) & soc_ok

        def pick(a, b):
            return torch.where(use_soc, b, a)

        dw, ds, dlam = pick(dw, dw2), pick(ds, ds2), pick(dlam, dlam2)
        dzl, dzu = pick(dzl, dzl2), pick(dzu, dzu2)
        a_p, a_d = pick(a_p, a_p2), pick(a_d, a_d2)
        f_type = pick(f_type, soc_ft)

        # filter backtracking line search, seeded with the full-step
        # decision: accepted steps take zero trips
        gphi_d = gphi_dot(dw, ds)
        gneg = -torch.clamp(gphi_d, max=0.0)
        amin2 = torch.where(
            gneg > 0, st.gamma_phi * theta_k / torch.clamp(gneg, min=_TINY),
            st.gamma_theta)
        amin3 = torch.where(
            (gneg > 0) & (theta_k <= stt.th_min),
            st.delta_switch * theta_k ** st.s_theta
            / torch.clamp(gneg ** st.s_phi, min=_TINY), inf)
        alpha_min = st.gamma_alpha * torch.minimum(
            torch.clamp(amin2, max=st.gamma_theta), amin3)

        alpha, ls_done, k = a_p, ok_full | use_soc, 0
        while not bool(ls_done) and k < st.ls_max \
                and bool(alpha * 0.5 >= alpha_min):
            alpha = alpha * 0.5
            ls_done, f_type = accept_fn(alpha, dw, ds, gphi_d)
            k += 1
        ls_failed = ~ls_done
        alpha = torch.where(ls_failed, 0.0, alpha)

        # -- feasibility restoration ---------------------------------------
        # a failed line search takes a minimum-norm step onto the
        # linearized constraints (backtracked on theta alone); failures at
        # an already feasible point take the alpha_min fallback step
        use_resto = ls_failed & (theta_k > 1e-12) if st.use_resto \
            else torch.zeros_like(ls_failed)

        def do_resto():
            dwr, dsr, _, dzlr, dzur = resolve_resto()
            fin = _all_finite(dwr, dsr, dzlr, dzur)
            dwr, dsr = torch.where(fin, dwr, 0.0), torch.where(fin, dsr, 0.0)
            dzlr = torch.where(fin, dzlr, 0.0)
            dzur = torch.where(fin, dzur, 0.0)
            a_pr, a_dr = fraction_to_boundary(w, s, dwr, dsr, zl, zu, dzlr,
                                              dzur, mu_new)
            al, r_ok, kk = a_pr, torch.zeros_like(use_resto), 0
            while not bool(r_ok) and kk < 12:
                s_t = s + al * dsr
                gv_t, hv_t = eval_all(w + al * dwr, p)
                th_t = constraint_violation(gv_t, hv_t, s_t)
                ok_t = torch.isfinite(th_t) & (
                    th_t <= (1.0 - 1e-4 * al) * theta_k)
                al = torch.where(ok_t, al, al * 0.5)
                r_ok = ok_t
                kk += 1
            return dwr, dsr, dzlr, dzur, al, a_dr, r_ok

        zero_r = (torch.zeros_like(dw), torch.zeros_like(ds),
                  torch.zeros_like(dzl), torch.zeros_like(dzu),
                  T(0.0), T(0.0), torch.zeros_like(use_resto))
        dwr, dsr, dzlr, dzur, al_r, a_dr, r_ok = \
            _cond_any(use_resto, do_resto, zero_r) if st.use_resto \
            else zero_r
        use_resto = use_resto & r_ok
        alpha = torch.where(use_resto, 0.0, alpha)
        # fallback for unrestorable failures: the alpha_min step keeps
        # strictly positive progress
        fallback = ls_failed & ~use_resto
        alpha = torch.where(
            fallback, torch.maximum(alpha_min, a_p * 0.5 ** st.ls_max), alpha)
        w_n = w + alpha * dw
        s_n = s + alpha * ds
        # select-gated, not multiplicative: 0 * NaN = NaN
        w_n = torch.where(use_resto, w_n + al_r * dwr, w_n)
        s_n = torch.where(use_resto, s_n + al_r * dsr, s_n)
        lam_n = lam + alpha * dlam
        eff_ad = torch.where(use_resto, a_dr, a_d)
        zl_n = zl + eff_ad * torch.where(use_resto, dzlr, dzl)
        zu_n = zu + eff_ad * torch.where(use_resto, dzur, dzu)
        # keep duals sane relative to the barrier (IPOPT's kappa_Sigma)
        dl_w, dl_s = dist_l(w_n, s_n)
        dl = torch.clamp(torch.cat([dl_w, dl_s]), min=_TINY)
        kap = 1e10
        zl_c = torch.minimum(torch.maximum(zl_n, mu_new / (kap * dl)),
                             kap * mu_new / dl)
        du = torch.clamp(torch.cat([dist_u(w_n),
                                    torch.full((q,), inf, dtype=dtype,
                                               device=device)]), min=_TINY)
        zu_c = torch.where(
            mask_zu, torch.minimum(torch.maximum(zu_n, mu_new / (kap * du)),
                                   kap * mu_new / du), 0.0)

        # filter augmentation (W-B A-6): h-type acceptances and line-search
        # failures at infeasible points carve out (theta, phi)
        add_entry = ((~ls_failed) & (~f_type)) \
            | (ls_failed & (theta_k > 1e-12))
        slot_hot = (slots == filt_n0 % st.filter_size) & add_entry
        filt_th1 = torch.where(slot_hot, (1.0 - st.gamma_theta) * theta_k,
                               filt_th0)
        filt_ph1 = torch.where(slot_hot, phi_k - st.gamma_phi * theta_k,
                               filt_ph0)
        filt_n1 = filt_n0 + add_entry.to(filt_n0.dtype)
        # per-iteration regularization: the successful delta decays
        prox_n = torch.where(
            ls_failed, torch.clamp(delta_used, min=1e-6) * 10.0,
            torch.where(alpha > 0.3, delta_used / 3.0, delta_used))
        prox_n = torch.clamp(prox_n, 0.0, st.prox_max)
        return (w_n, s_n, lam_n, zl_c, zu_c, mu_new, prox_n, filt_th1,
                filt_ph1, filt_n1)

    def body(stt, p):
        w, s, lam, zl, zu = stt.w, stt.s, stt.lam, stt.zl, stt.zu
        with _range("ipm.evals"):
            pre = point_evals(w, lam, p)
            res0 = kkt_residuals(w, s, lam, zl, zu, p, pre=pre)
            err_0 = err_from(res0, 0.0)
            converged = err_0 <= st.tol
        if bool(converged):
            # a converged state is frozen (the JAX body computes the step
            # and discards it); the loop exits after this pass
            new = (w, s, lam, zl, zu, stt.mu, stt.prox, stt.filt_th,
                   stt.filt_ph, stt.filt_n)
        else:
            with _range("ipm.step"):
                new = take_step(stt, p, pre, res0, err_from(res0, stt.mu))
        (w_n, s_n, lam_n, zl_n, zu_n, mu_n, prox_n, fth, fph, fn) = new
        # watchdog: remember the best-seen iterate by true KKT error
        improve = err_0 < stt.best_err
        best_n = tuple(torch.where(improve, cur, old)
                       for cur, old in zip((w, s, lam, zl, zu), stt.best))
        return IPMState(
            w=w_n, s=s_n, lam=lam_n, zl=zl_n, zu=zu_n, mu=mu_n,
            it=stt.it + 1, converged=converged, kkt_err=err_0, prox=prox_n,
            best=best_n, best_err=torch.where(improve, err_0, stt.best_err),
            filt_th=fth, filt_ph=fph, filt_n=fn, th_max=stt.th_max,
            th_min=stt.th_min)

    def solver_loop(state, p):
        while not bool(state.converged) and state.it < st.max_iter:
            state = body(state, p)
        return state

    def init_state(w0, p, lam0=None, mu0=None, zl0=None, zu0=None):
        # push the initial point into the interior (IPOPT bound_push/frac)
        k1, k2 = st.bound_push, st.bound_frac
        lo = torch.where(has_lb, lb, -inf)
        hi = torch.where(has_ub, ub, inf)
        rng = torch.where(has_lb & has_ub, hi - lo, inf)
        pl = torch.where(has_lb, torch.minimum(
            k1 * torch.clamp(torch.abs(lo), min=1.0), k2 * rng), 0.0)
        pu = torch.where(has_ub, torch.minimum(
            k1 * torch.clamp(torch.abs(hi), min=1.0), k2 * rng), 0.0)
        w = torch.minimum(torch.maximum(w0, torch.where(has_lb, lo + pl,
                                                        -inf)),
                          torch.where(has_ub, hi - pu, inf))
        _, hv = eval_all(w, p)
        s = torch.clamp(-hv, min=st.slack_min) if q else empty
        mu = T(st.mu_init if mu0 is None else mu0)
        lam = torch.zeros((m + q,), dtype=dtype, device=device) \
            if lam0 is None else lam0
        z0v = st.z_init
        zl = torch.cat([torch.where(has_lb, z0v, 0.0),
                        torch.full((q,), z0v, dtype=dtype, device=device)])
        zu = torch.cat([torch.where(has_ub, z0v, 0.0),
                        torch.zeros((q,), dtype=dtype, device=device)])
        # warm entries the previous solve zeroed restart at z_init
        if zl0 is not None:
            zl = torch.where(zl0 > 1e-12, torch.maximum(zl0, mu / 1e8),
                             torch.where(mask_l, zl, 0.0))
        if zu0 is not None:
            zu = torch.where(zu0 > 1e-12, torch.maximum(zu0, mu / 1e8),
                             torch.where(mask_zu, zu, 0.0))
        gv0, hv0 = eval_all(w, p)
        theta0 = constraint_violation(gv0, hv0, s)
        theta0 = torch.where(torch.isfinite(theta0), theta0, 1.0)
        return IPMState(
            w=w, s=s, lam=lam, zl=zl, zu=zu, mu=mu, it=0,
            converged=torch.zeros((), dtype=torch.bool, device=device),
            kkt_err=T(inf), prox=T(0.0), best=(w, s, lam, zl, zu),
            best_err=T(inf),
            filt_th=torch.full((st.filter_size,), inf, dtype=dtype,
                               device=device),
            filt_ph=torch.full((st.filter_size,), inf, dtype=dtype,
                               device=device),
            filt_n=torch.zeros((), dtype=torch.int64, device=device),
            th_max=1e4 * torch.clamp(theta0, min=1.0),
            th_min=1e-4 * torch.clamp(theta0, min=1.0))

    # -- active-set Newton polish ------------------------------------------
    # A few full Newton steps with the active set FIXED (active bounds
    # pinned by a large quadratic penalty, inactive inequality multipliers
    # driven to zero) converge quadratically to the exact KKT point.
    BIG = 1e10

    def polish(w, s, lam, zl, zu, p):
        dl_w = torch.where(has_lb, w - lb, inf)
        du_w = torch.where(has_ub, ub - w, inf)
        act_lb = has_lb & (zl[:n] > dl_w)
        act_ub = has_ub & (zu[:n] > du_w)
        act_h = (zl[n:] > s) if q else zeros_qb
        act_b = act_lb | act_ub
        target = torch.where(act_ub, ub, torch.where(act_lb, lb, 0.0))
        target = torch.where(torch.isfinite(target), target, 0.0)
        w_, lam_ = w, lam
        for _ in range(3):
            lam_g, lam_h = lam_[:m], lam_[m:]
            r_dw = grad_f(w_, p) + jgT_mv(w_, p, lam_g) \
                + jhT_mv(w_, p, lam_h) \
                + BIG * torch.where(act_b, w_ - target, 0.0)
            r_g, hv = eval_all(w_, p)
            # active ineq -> equality (inv_sig 0); inactive -> lam -> 0
            inv_sig = torch.where(act_h, 0.0, BIG) if q else empty
            r_h_mod = hv - lam_h * inv_sig
            sig_pol = torch.where(act_b, BIG, 0.0)
            if structured_solve is not None:
                ctx_ = structured_solve[0](w_, p, lam_g, lam_h, sig_pol,
                                           inv_sig)
                dw_, dg_, dh_ = structured_solve[1](ctx_, r_dw, r_g,
                                                    r_h_mod, T(0.0))
            else:
                Jg_ = jac_g(w_, p) if m else empty.reshape(0, n)
                Jh_ = jac_h(w_, p) if q else empty.reshape(0, n)
                dw_, dg_, dh_ = solve_kkt(
                    hess_fn(w_, p, lam_g, lam_h), sig_pol, Jg_, Jh_,
                    inv_sig, r_dw, r_g, r_h_mod, T(0.0))
            good = _all_finite(dw_, dg_, dh_)
            w_ = torch.where(good, w_ + dw_, w_)
            lam_ = torch.where(good, lam_ + torch.cat([dg_, dh_]), lam_)
        # bound duals and slacks consistent with the polished point
        lam_gp, lam_hp = lam_[:m], lam_[m:]
        r_stat = grad_f(w_, p) + jgT_mv(w_, p, lam_gp) \
            + jhT_mv(w_, p, lam_hp)
        zl_p = torch.cat([
            torch.where(act_lb, torch.clamp(r_stat, min=0.0), 0.0),
            torch.where(act_h, torch.clamp(lam_hp, min=0.0), 0.0)])
        zu_p = torch.cat([
            torch.where(act_ub, torch.clamp(-r_stat, min=0.0), 0.0),
            torch.zeros((q,), dtype=dtype, device=device)])
        w_cl = torch.minimum(torch.maximum(w_, torch.where(has_lb, lb, -inf)),
                             torch.where(has_ub, ub, inf))
        _, hv_p = eval_all(w_cl, p)
        s_p = torch.clamp(-hv_p, min=0.0)
        return w_cl, s_p, lam_, zl_p, zu_p

    def _select(cond, a, b):
        return tuple(torch.where(cond, y, x) for x, y in zip(a, b))

    def solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None):
        state = init_state(w0, p, lam0=lam0, mu0=mu0, zl0=zl0, zu0=zu0)
        final = solver_loop(state, p)
        cur = (final.w, final.s, final.lam, final.zl, final.zu)
        if not st.do_polish:
            # watchdog: ties return the evaluated best tuple (final.w is
            # one step past the last evaluated error on a max_iter exit)
            wd = final.best_err <= final.kkt_err
            w_r, s_r, lam_r, zl_r, zu_r = _select(wd, cur, final.best)
            err_r = torch.where(wd, final.best_err, final.kkt_err)
            return IPMSolution(
                w=w_r, s=s_r, lam=lam_r, zl=zl_r, zu=zu_r, f=f(w_r, p),
                kkt_err=err_r, iterations=final.it,
                success=final.converged | (err_r <= st.tol))
        # watchdog: polish whichever of (final state, best-seen iterate)
        # has the smaller true KKT error
        err_fin = kkt_error(*cur, p, 0.0)
        wd = final.best_err < err_fin
        start = _select(wd, cur, final.best)
        err_ipm = torch.where(wd, final.best_err, err_fin)
        with _range("ipm.polish"):
            pol = polish(*start, p)
        err_pol = kkt_error(*pol, p, 0.0)
        better = torch.isfinite(err_pol) & (err_pol < err_ipm)
        w_f, s_f, lam_f, zl_f, zu_f = _select(better, start, pol)
        err_f = torch.where(better, err_pol, err_ipm)
        return IPMSolution(
            w=w_f, s=s_f, lam=lam_f, zl=zl_f, zu=zu_f, f=f(w_f, p),
            kkt_err=err_f, iterations=final.it,
            success=final.converged | (err_f <= st.tol))

    return solve
