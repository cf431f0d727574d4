"""Primal-dual interior-point NLP solver (PyTorch port), batch-first.

Counterpart of the JAX package's ``solver/ipm.py`` on its default path:
Fiacco-McCormick barrier loop with exact-Hessian primal-dual Newton steps,
the Wächter-Biegler (theta, phi) filter line search, second-order
correction, the regularization ladder capped at ``prox_max``, the dual
trust region ``dual_cap``, select-gated feasibility restoration
(``use_resto``), the best-iterate watchdog and the active-set Newton
polish.

Problem form:

    min_w f(w, p)   s.t.  g(w, p) = 0,  h(w, p) <= 0,  lb <= w <= ub

Every state field has a leading batch axis (B,): B instances are solved in
lockstep, each exactly as it would be alone.  These are the semantics of
``jax.vmap`` over the JAX solver: its ``lax.while_loop`` becomes a Python
loop that runs while any element is unfinished, and elements that are
finished are frozen by ``torch.where``; ``_cond_any`` (skip a branch when
no element needs it) is a host-side ``if`` on the predicate's ``any()``.
``MPC.make_step`` solves with B=1.
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
    """Solver state; every field has the leading batch axis (B,)."""
    w: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor      # equality multipliers [g; h+s]
    zl: torch.Tensor       # lower bound duals for [w; s]
    zu: torch.Tensor       # upper bound duals for [w; s]
    mu: torch.Tensor
    it: torch.Tensor       # iterations taken, per element
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
    iterations: torch.Tensor
    success: torch.Tensor


_TINY = 1e-30  # safe positive floor that survives float32


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _cond_any(pred, true_fn, false_val):
    """Run ``true_fn`` only when some element's predicate holds (the JAX
    package's zero-trip ``while_loop``, here a host-side ``if``)."""
    return true_fn() if bool(torch.as_tensor(pred).any()) else false_val


def _c(x):
    """A per-element (B,) value as a column against (B, k) tensors; Python
    scalars pass through."""
    return x[..., None] if torch.is_tensor(x) and x.ndim else x


def _sel(cond, new, old):
    """Per-element select: ``cond`` (B,) broadcast over ``new``/``old``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _maxabs(x):
    """max |x| over the last axis, 0 where it is empty (jnp
    ``initial=0.0``)."""
    return x.abs().amax(-1) if x.shape[-1] else x.new_zeros(x.shape[:-1])


def _all_finite(*xs):
    out = torch.isfinite(xs[0]).all(-1)
    for x in xs[1:]:
        out = out & torch.isfinite(x).all(-1)
    return out


def _dot(a, b):
    return (a * b).sum(-1)


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
    """Build ``solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None) ->
    IPMSolution``.

    ``w0`` (B, n) with ``p`` (B, n_p) solves B instances in lockstep, each
    as it would be solved alone; the solution's fields keep the batch axis
    (``iterations`` is a per-element tensor).  ``mu0`` is a scalar or (B,).
    ``solve.newton_steps`` counts the Newton steps the batch took (one per
    loop pass in which some element was unconverged).

    The callables are batch-first: f: (B,n),(B,n_p) -> (B,); g, h ->
    (B,rows); ``grad_f_fn`` -> (B,n); ``jac_*_fn`` -> (B,rows,n);
    ``hess_fn(w, p, lam_g, lam_h)`` -> (B,n,n).  ``lb/ub`` are numpy
    arrays (may contain +-inf), moved to
    ``device`` in ``dtype``.  ``structured_solve`` is a ``(prepare,
    solve)`` pair: ``prepare(w, p, lam_g, lam_h, sig_w, inv_sig_s)`` once
    per Newton step, ``solve(ctx, r_dw, r_g, r_h_mod, delta) -> (dw,
    dlam_g, dlam_h)`` for every right-hand side, with (B, ...) arguments
    and ``delta`` (B,).  Without it the KKT system is solved densely.
    ``device`` and ``dtype`` default to the environment's choice
    (``DOMPC_TPU_PLATFORM``, ``DOMPC_TPU_X64``): CUDA unless the CPU is
    asked for.
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
    inf = float("inf")
    vmap = torch.func.vmap

    def one(fn):
        """One instance's view of a batch-first callable."""
        return lambda w, p: fn(w[None], p[None])[0]
    f1, g1, h1 = one(f), one(g) if m else None, one(h) if q else None
    grad_f = grad_f_fn if grad_f_fn is not None else \
        torch.func.grad(lambda w, p: f(w, p).sum())
    jac_g = jac_g_fn if jac_g_fn is not None else (
        vmap(torch.func.jacfwd(g1)) if m else None)
    jac_h = jac_h_fn if jac_h_fn is not None else (
        vmap(torch.func.jacfwd(h1)) if q else None)
    if hess_fn is None:
        def lagrangian(w, p, lam_g, lam_h):
            val = f1(w, p)
            if m:
                val = val + torch.dot(lam_g, g1(w, p))
            if q:
                val = val + torch.dot(lam_h, h1(w, p))
            return val
        hess_fn = vmap(torch.func.hessian(lagrangian))

    def empty(w):
        return w.new_zeros(w.shape[:-1] + (0,))

    def eval_all(w, p):
        return (g(w, p) if m else empty(w)), (h(w, p) if q else empty(w))

    # Jacobian-vector products (used instead of materialized Jacobians
    # wherever possible, and exclusively in structured mode).  Row b of a
    # batched g depends on row b of w only, so one vjp/jvp over the batch
    # is the per-element product.
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
            return empty(w)
        return torch.func.jvp(lambda ww: g(ww, p), (w,), (dx,))[1]

    def jh_mv(w, p, dx):
        if not q:
            return empty(w)
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
        val = val - mu * torch.where(has_lb, torch.log(dl), 0.0).sum(-1)
        val = val - mu * torch.where(has_ub, torch.log(du), 0.0).sum(-1)
        if q:
            val = val - mu * torch.log(s).sum(-1)
        return val

    def constraint_violation(gv, hv, s):
        vio = gv.abs().sum(-1) if m else gv.new_zeros(gv.shape[:-1])
        if q:
            vio = vio + (hv + s).abs().sum(-1)
        return vio

    # -- KKT error ---------------------------------------------------------
    def point_evals(w, lam, p):
        """(gradient, residuals, J^T lam) shared by the KKT-error check and
        the Newton step at the same point."""
        gf = grad_f(w, p)
        gv, hv = eval_all(w, p)
        jtl = jgT_mv(w, p, lam[:, :m]) + jhT_mv(w, p, lam[:, m:])
        return gf, gv, hv, jtl

    mask_l = torch.cat([has_lb, ones_q])
    mask_zu = torch.cat([has_ub, zeros_qb])

    def kkt_residuals(w, s, lam, zl, zu, p, pre=None):
        """Mu-independent residual summary (one evaluation serves
        err_mu / err_0 / err_{mu_new})."""
        gf, gv, hv, jtl = pre if pre is not None else point_evals(
            w, lam, p)
        r_dw = gf + jtl
        r_dw = r_dw - torch.where(has_lb, zl[:, :n], 0.0) \
            + torch.where(has_ub, zu[:, :n], 0.0)
        r_ds = (lam[:, m:] - zl[:, n:]) if q else empty(w)
        r_p = torch.cat([gv, hv + s], -1)
        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        comp_l = torch.cat([torch.where(has_lb, dl_w * zl[:, :n], 0.0),
                            dl_s * zl[:, n:]], -1)
        comp_u = torch.where(has_ub, du_w * zu[:, :n], 0.0)
        z_sum = zl.abs().sum(-1) + zu.abs().sum(-1)
        lam_sum = lam.abs().sum(-1)
        denom = n + q + m
        s_d = torch.clamp((lam_sum + z_sum) / max(denom, 1),
                          min=st.s_max) / st.s_max
        s_c = torch.clamp(z_sum / max(n + q, 1), min=st.s_max) / st.s_max
        err_d = _maxabs(torch.cat([r_dw, r_ds], -1)) / s_d
        err_p = _maxabs(r_p)
        return err_d, err_p, comp_l, comp_u, s_c

    def err_from(res, mu):
        err_d, err_p, comp_l, comp_u, s_c = res
        c_l = torch.where(mask_l, comp_l - _c(mu), 0.0)
        c_u = torch.where(has_ub, comp_u - _c(mu), 0.0)
        err_c = torch.maximum(_maxabs(c_l), _maxabs(c_u)) / s_c
        return torch.maximum(torch.maximum(err_d, err_p), err_c)

    def kkt_error(w, s, lam, zl, zu, p, mu):
        return err_from(kkt_residuals(w, s, lam, zl, zu, p), mu)

    # -- dense KKT solve ---------------------------------------------------
    def dense_kkt(Hw, Sig_w, Jg, Jh, inv_sig_s, r_dw, r_g, r_h_mod, delta):
        B, dim = Hw.shape[0], n + m + q
        K = Hw.new_zeros((B, dim, dim))
        K[:, :n, :n] = Hw + torch.diag_embed(Sig_w + _c(delta))
        if m:
            K[:, :n, n:n + m] = Jg.transpose(1, 2)
            K[:, n:n + m, :n] = Jg
        if q:
            K[:, :n, n + m:] = Jh.transpose(1, 2)
            K[:, n + m:, :n] = Jh
            K[:, n + m:, n + m:] = -torch.diag_embed(inv_sig_s)
        K[:, n:, n:] -= st.delta_cons * torch.eye(m + q, dtype=dtype,
                                                  device=device)
        # solve_ex: singular K gives non-finite values (rejected by the
        # callers), as with jnp.linalg.solve, instead of raising
        rhs = torch.cat([-r_dw, -r_g, -r_h_mod], -1)[..., None]
        sol = torch.linalg.solve_ex(K, rhs)[0][..., 0]
        return sol[:, :n], sol[:, n:n + m], sol[:, n + m:]

    solve_kkt = kkt_solve if kkt_solve is not None else dense_kkt

    # -- one Newton iteration at fixed mu ----------------------------------
    def newton_step(w, s, lam, zl, zu, p, mu, prox, pre, live):
        """``live`` (B,): the elements whose step is used; host-side skips
        look at those only (the others' results are discarded)."""
        B = w.shape[0]
        lam_g, lam_h = lam[:, :m], lam[:, m:]
        gf, gv, hv, jtl = pre

        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        dl_w = torch.clamp(dl_w, min=_TINY)
        du_w = torch.clamp(du_w, min=_TINY)
        dl_s = torch.clamp(dl_s, min=_TINY)

        sig_w = torch.where(has_lb, zl[:, :n] / dl_w, 0.0) \
            + torch.where(has_ub, zu[:, :n] / du_w, 0.0)
        sig_s = zl[:, n:] / dl_s

        # barrier-gradient form of the dual residual
        r_dw = gf + jtl \
            - torch.where(has_lb, _c(mu) / dl_w, 0.0) \
            + torch.where(has_ub, _c(mu) / du_w, 0.0)
        r_ds = lam_h - _c(mu) / dl_s if q else empty(w)
        r_g = gv
        r_h = hv + s
        inv_sig_s = 1.0 / torch.clamp(sig_s, min=_TINY) if q else empty(w)
        r_h_mod = r_h - r_ds * inv_sig_s

        def bvec(delta):
            return T(delta).expand(B)

        if structured_solve is not None:
            # derivatives + assembly once per Newton step; the retry ladder
            # and the second-order correction reuse the assembled system
            s_prepare, s_solve = structured_solve
            with _range("kkt.prepare"):
                kkt_ctx = s_prepare(w, p, lam_g, lam_h, sig_w, inv_sig_s)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                with _range("kkt.solve"):
                    return s_solve(kkt_ctx, r_dw_, r_g_, r_h_mod_,
                                   bvec(delta))

            def lag_grad(ww):
                return (grad_f(ww, p) + jgT_mv(ww, p, lam_g)
                        + jhT_mv(ww, p, lam_h))

            def hvp(dx):
                # Lagrangian Hessian-vector product via jvp of the gradient
                return torch.func.jvp(lag_grad, (w,), (dx,))[1]
        else:
            Jg = jac_g(w, p) if m else w.new_zeros((B, 0, n))
            Jh = jac_h(w, p) if q else w.new_zeros((B, 0, n))
            Hw = hess_fn(w, p, lam_g, lam_h)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                return solve_kkt(Hw, sig_w, Jg, Jh, inv_sig_s, r_dw_, r_g_,
                                 r_h_mod_, bvec(delta))

            def hvp(dx):
                return (Hw @ dx[..., None])[..., 0]

        def do_solve(delta):
            return do_solve_rhs(r_dw, r_g, r_h_mod, delta)

        rhs_norm = torch.maximum(torch.maximum(_maxabs(r_dw), _maxabs(r_g)),
                                 _maxabs(r_h_mod)) + 1e-12

        def step_residual(step, delta, Hd):
            dw_, dg_, dh_ = step
            res_w = (Hd + (sig_w + _c(delta)) * dw_ + r_dw
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
            curv = _dot(dw_, Hd) + ((sig_w + _c(delta)) * dw_ * dw_).sum(-1)
            wrong_curv = curv < -1e-10 * (1.0 + _dot(dw_, dw_))
            inaccurate = step_residual(step, delta, Hd) > 1e-2 * rhs_norm
            return bad | wrong_curv | inaccurate

        # regularization ladder: escalate the primal regularization of the
        # elements whose step is bad; rung deltas are capped at prox_max.
        # A rung runs when some element needs it, and the others keep their
        # step; when no element needs a rung, no later rung would run
        # either (each would test the same steps), so the ladder ends.
        step = do_solve(prox)
        prev_delta = prox
        for mult in (10.0, 1e2, 1e3, 1e5, 1e7)[:st.reg_retries]:
            bad = need_retry(step, prev_delta) & live
            if not bool(bad.any()):
                break
            delta = torch.clamp(torch.clamp(prox, min=1e-8) * mult,
                                max=st.prox_max)
            step = tuple(_sel(bad, new, old)
                         for new, old in zip(do_solve(delta), step))
            prev_delta = torch.where(bad, delta, prev_delta)

        dw, dlam_g, dlam_h = step
        # non-finite guard: zero the step and escalate the Levenberg prox
        step_ok = _all_finite(dw, dlam_g, dlam_h)
        dw = _sel(step_ok, dw, torch.zeros_like(dw))
        dlam_g = _sel(step_ok, dlam_g, torch.zeros_like(dlam_g))
        dlam_h = _sel(step_ok, dlam_h, torch.zeros_like(dlam_h))
        prev_delta = torch.where(step_ok, prev_delta,
                                 torch.clamp(prox, min=1e-8) * 100.0)

        def recover(dw_, dlam_g_, dlam_h_, r_h_used):
            ds_ = -(r_h_used + jh_mv(w, p, dw_)) if q else empty(w)
            dlam_ = torch.cat([dlam_g_, dlam_h_], -1)
            dzl_w = torch.where(
                has_lb, _safe_div(_c(mu) - zl[:, :n] * dl_w, dl_w)
                - _safe_div(zl[:, :n] * dw_, dl_w), 0.0)
            dzl_s = _safe_div(_c(mu) - zl[:, n:] * dl_s, dl_s) \
                - _safe_div(zl[:, n:] * ds_, dl_s) if q else empty(w)
            dzu_w = torch.where(
                has_ub, _safe_div(_c(mu) - zu[:, :n] * du_w, du_w)
                + _safe_div(zu[:, :n] * dw_, du_w), 0.0)
            return (dw_, ds_, dlam_, torch.cat([dzl_w, dzl_s], -1),
                    torch.cat([dzu_w, torch.zeros_like(dzl_s)], -1))

        def resolve_soc(alpha):
            """Second-order correction: re-solve with the constraint value
            at the trial point."""
            w_t = w + _c(alpha) * dw
            gv_t, hv_t = eval_all(w_t, p)
            r_g_soc = _c(alpha) * r_g + gv_t
            r_h_soc = _c(alpha) * r_h + hv_t + (
                s + _c(alpha) * (-(r_h + jh_mv(w, p, dw))) if q
                else empty(w))
            r_h_mod_soc = r_h_soc - r_ds * inv_sig_s if q else empty(w)
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
        out = x.new_ones(x.shape[:-1])
        return torch.minimum(out, ratio.amin(-1)) if ratio.shape[-1] \
            else out

    def dual_alpha(zl, zu, dzl, dzu, mu):
        tau = _c(torch.clamp(1.0 - mu, min=st.tau_min))
        a_d = max_alpha(zl, dzl, tau * zl, mask_l)
        return torch.minimum(a_d, max_alpha(zu, dzu, tau * zu, mask_zu))

    def fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu, mu):
        tau = _c(torch.clamp(1.0 - mu, min=st.tau_min))
        dl_w, dl_s = dist_l(w, s)
        du_w = dist_u(w)
        a_p = max_alpha(w, dw, tau * dl_w, has_lb)
        a_p = torch.minimum(a_p, max_alpha(w, -dw, tau * du_w, has_ub))
        if q:
            a_p = torch.minimum(a_p, max_alpha(s, ds, tau * dl_s, ones_q))
        return a_p, dual_alpha(zl, zu, dzl, dzu, mu)

    # -- main loop ----------------------------------------------------------
    slots = torch.arange(st.filter_size, device=device)

    def take_step(stt, p, pre, res0, err_mu, live):
        """One globalized iteration; the results of elements outside
        ``live`` are discarded by the caller."""
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
        filt_th0 = torch.where(_c(mu_dec), inf, stt.filt_th)
        filt_ph0 = torch.where(_c(mu_dec), inf, stt.filt_ph)
        filt_n0 = torch.where(mu_dec, 0, stt.filt_n)

        with _range("ipm.newton"):
            (dw, ds, dlam, dzl, dzu, resolve_soc, delta_used,
             resolve_resto) = newton_step(w, s, lam, zl, zu, p, mu_new,
                                          stt.prox, pre, live)
        # dual trust region: primal acceptance cannot see multiplier
        # explosions, so bound them here
        dl_norm = _maxabs(dlam)
        l_norm = _maxabs(lam)
        dlam = dlam * _c(torch.clamp(st.dual_cap * (1.0 + l_norm)
                                     / torch.clamp(dl_norm, min=_TINY),
                                     max=1.0))
        a_p, a_d = fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu,
                                        mu_new)
        err_ref = err_from(res0, mu_new)

        def kkt_decrease(alpha, dw_, ds_, dlam_, dzl_, dzu_, a_d_):
            err_t = kkt_error(w + _c(alpha) * dw_, s + _c(alpha) * ds_,
                              lam + _c(alpha) * dlam_, zl + _c(a_d_) * dzl_,
                              zu + _c(a_d_) * dzu_, p, mu_new)
            return torch.isfinite(err_t) & (err_t < 0.99 * err_ref)

        theta_k = constraint_violation(pre[1], pre[2], s)
        phi_k = barrier_value(w, s, p, mu_new)

        def gphi_dot(dw_, ds_):
            """Directional derivative of the barrier objective."""
            dlw_, dls_ = dist_l(w, s)
            duw_ = dist_u(w)
            gphi_w = pre[0] \
                - torch.where(has_lb,
                              _c(mu_new) / torch.clamp(dlw_, min=_TINY), 0.0) \
                + torch.where(has_ub,
                              _c(mu_new) / torch.clamp(duw_, min=_TINY), 0.0)
            out = _dot(gphi_w, dw_)
            if q:
                out = out + _dot(
                    -_c(mu_new) / torch.clamp(dls_, min=_TINY), ds_)
            return out

        def accept_fn(alpha, dw_, ds_, gphi_d_):
            """W-B acceptance: acceptable to the filter AND either (f-type:
            switching holds -> Armijo on phi) or (h-type: sufficient
            decrease in theta or phi).  Returns (ok, f_type)."""
            w_t = w + _c(alpha) * dw_
            s_t = s + _c(alpha) * ds_
            phi_t = barrier_value(w_t, s_t, p, mu_new)
            gv_t, hv_t = eval_all(w_t, p)
            th_t = constraint_violation(gv_t, hv_t, s_t)
            fil_ok = torch.all(
                (_c(th_t) <= (1.0 - st.gamma_theta) * filt_th0)
                | (_c(phi_t) <= filt_ph0 - st.gamma_phi * filt_th0), -1)
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
        # as f-type; it only matters where the filter test is not already
        # an f-type acceptance, so it is computed when some element needs
        # it and selected.
        acc0, ft0 = accept_fn(a_p, dw, ds, gphi_dot(dw, ds))
        need_kd = ~(acc0 & ft0)
        kd0 = _cond_any(need_kd & live,
                        lambda: kkt_decrease(a_p, dw, ds, dlam, dzl, dzu,
                                             a_d),
                        torch.zeros_like(acc0))
        kd0 = torch.where(need_kd, kd0, True)
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
             a_d2) = _cond_any(~ok_full & live, do_soc, no_soc)
        else:
            (soc_ok, soc_ft, dw2, ds2, dlam2, dzl2, dzu2, a_p2,
             a_d2) = no_soc
        use_soc = (~ok_full) & soc_ok

        def pick(a, b):
            return _sel(use_soc, b, a)

        dw, ds, dlam = pick(dw, dw2), pick(ds, ds2), pick(dlam, dlam2)
        dzl, dzu = pick(dzl, dzl2), pick(dzu, dzu2)
        a_p, a_d = pick(a_p, a_p2), pick(a_d, a_d2)
        f_type = pick(f_type, soc_ft)

        # filter backtracking line search, seeded with the full-step
        # decision: accepted elements take zero trips, and it runs while
        # some element is unfinished, finished elements frozen (the JAX
        # while_loop under vmap)
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

        alpha, ls_done = a_p, ok_full | use_soc
        k = torch.zeros_like(stt.it)
        while True:
            go = ~ls_done & (k < st.ls_max) & (alpha * 0.5 >= alpha_min)
            if not bool((go & live).any()):
                break
            a_try = alpha * 0.5
            ok_t, ft_t = accept_fn(a_try, dw, ds, gphi_d)
            alpha = torch.where(go, a_try, alpha)
            f_type = torch.where(go, ft_t, f_type)
            ls_done = ls_done | (go & ok_t)
            k = k + go
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
            dwr = _sel(fin, dwr, torch.zeros_like(dwr))
            dsr = _sel(fin, dsr, torch.zeros_like(dsr))
            dzlr = _sel(fin, dzlr, torch.zeros_like(dzlr))
            dzur = _sel(fin, dzur, torch.zeros_like(dzur))
            a_pr, a_dr = fraction_to_boundary(w, s, dwr, dsr, zl, zu, dzlr,
                                              dzur, mu_new)
            al, r_ok = a_pr, ~use_resto
            for _ in range(12):
                go = ~r_ok
                if not bool((go & live).any()):
                    break
                s_t = s + _c(al) * dsr
                gv_t, hv_t = eval_all(w + _c(al) * dwr, p)
                th_t = constraint_violation(gv_t, hv_t, s_t)
                ok_t = torch.isfinite(th_t) & (
                    th_t <= (1.0 - 1e-4 * al) * theta_k)
                al = torch.where(go & ~ok_t, al * 0.5, al)
                r_ok = r_ok | (go & ok_t)
            return dwr, dsr, dzlr, dzur, al, a_dr, r_ok

        zero_r = (torch.zeros_like(dw), torch.zeros_like(ds),
                  torch.zeros_like(dzl), torch.zeros_like(dzu),
                  torch.zeros_like(alpha), torch.zeros_like(alpha),
                  torch.zeros_like(use_resto))
        dwr, dsr, dzlr, dzur, al_r, a_dr, r_ok = \
            _cond_any(use_resto & live, do_resto, zero_r) if st.use_resto \
            else zero_r
        use_resto = use_resto & r_ok
        alpha = torch.where(use_resto, 0.0, alpha)
        # fallback for unrestorable failures: the alpha_min step keeps
        # strictly positive progress
        fallback = ls_failed & ~use_resto
        alpha = torch.where(
            fallback, torch.maximum(alpha_min, a_p * 0.5 ** st.ls_max), alpha)
        w_n = w + _c(alpha) * dw
        s_n = s + _c(alpha) * ds
        # select-gated, not multiplicative: 0 * NaN = NaN
        w_n = _sel(use_resto, w_n + _c(al_r) * dwr, w_n)
        s_n = _sel(use_resto, s_n + _c(al_r) * dsr, s_n)
        lam_n = lam + _c(alpha) * dlam
        eff_ad = torch.where(use_resto, a_dr, a_d)
        zl_n = zl + _c(eff_ad) * _sel(use_resto, dzlr, dzl)
        zu_n = zu + _c(eff_ad) * _sel(use_resto, dzur, dzu)
        # keep duals sane relative to the barrier (IPOPT's kappa_Sigma)
        dl_w, dl_s = dist_l(w_n, s_n)
        dl = torch.clamp(torch.cat([dl_w, dl_s], -1), min=_TINY)
        kap = 1e10
        zl_c = torch.minimum(torch.maximum(zl_n, _c(mu_new) / (kap * dl)),
                             kap * _c(mu_new) / dl)
        du = torch.clamp(torch.cat([dist_u(w_n),
                                    torch.full_like(s_n, inf)], -1),
                         min=_TINY)
        zu_c = torch.where(
            mask_zu, torch.minimum(torch.maximum(zu_n,
                                                 _c(mu_new) / (kap * du)),
                                   kap * _c(mu_new) / du), 0.0)

        # filter augmentation (W-B A-6): h-type acceptances and line-search
        # failures at infeasible points carve out (theta, phi)
        add_entry = ((~ls_failed) & (~f_type)) \
            | (ls_failed & (theta_k > 1e-12))
        slot_hot = (slots == _c(filt_n0 % st.filter_size)) & _c(add_entry)
        filt_th1 = torch.where(slot_hot, _c((1.0 - st.gamma_theta) * theta_k),
                               filt_th0)
        filt_ph1 = torch.where(slot_hot, _c(phi_k - st.gamma_phi * theta_k),
                               filt_ph0)
        filt_n1 = filt_n0 + add_entry.to(filt_n0.dtype)
        # per-iteration regularization: the successful delta decays
        prox_n = torch.where(
            ls_failed, torch.clamp(delta_used, min=1e-6) * 10.0,
            torch.where(alpha > 0.3, delta_used / 3.0, delta_used))
        prox_n = torch.clamp(prox_n, 0.0, st.prox_max)
        return (w_n, s_n, lam_n, zl_c, zu_c, mu_new, prox_n, filt_th1,
                filt_ph1, filt_n1)

    def body(stt, p, active):
        """One loop pass; the caller keeps its results for ``active``
        elements only."""
        w, s, lam, zl, zu = stt.w, stt.s, stt.lam, stt.zl, stt.zu
        with _range("ipm.evals"):
            pre = point_evals(w, lam, p)
            res0 = kkt_residuals(w, s, lam, zl, zu, p, pre=pre)
            err_0 = err_from(res0, 0.0)
            converged = err_0 <= st.tol
        old = (w, s, lam, zl, zu, stt.mu, stt.prox, stt.filt_th,
               stt.filt_ph, stt.filt_n)
        live = active & ~converged
        if bool(live.any()):
            # a converged element is frozen (the JAX body computes its
            # step and discards it); it leaves the loop after this pass
            with _range("ipm.step"):
                new = take_step(stt, p, pre, res0, err_from(res0, stt.mu),
                                live)
            solve.newton_steps += 1
            new = tuple(_sel(converged, o, nw) for o, nw in zip(old, new))
        else:
            new = old
        (w_n, s_n, lam_n, zl_n, zu_n, mu_n, prox_n, fth, fph, fn) = new
        # watchdog: remember the best-seen iterate by true KKT error
        improve = err_0 < stt.best_err
        best_n = tuple(_sel(improve, cur, old_)
                       for cur, old_ in zip((w, s, lam, zl, zu), stt.best))
        return IPMState(
            w=w_n, s=s_n, lam=lam_n, zl=zl_n, zu=zu_n, mu=mu_n,
            it=stt.it + 1, converged=converged, kkt_err=err_0, prox=prox_n,
            best=best_n, best_err=torch.where(improve, err_0, stt.best_err),
            filt_th=fth, filt_ph=fph, filt_n=fn, th_max=stt.th_max,
            th_min=stt.th_min)

    def freeze(active, new, old):
        out = []
        for nw, o in zip(new, old):
            if isinstance(o, tuple):
                out.append(tuple(_sel(active, a, b) for a, b in zip(nw, o)))
            else:
                out.append(_sel(active, nw, o))
        return IPMState(*out)

    def solver_loop(state, p):
        while True:
            active = ~state.converged & (state.it < st.max_iter)
            if not bool(active.any()):
                return state
            state = freeze(active, body(state, p, active), state)

    def init_state(w0, p, lam0=None, mu0=None, zl0=None, zu0=None):
        B = w0.shape[0]
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
        s = torch.clamp(-hv, min=st.slack_min) if q else empty(w)
        mu = T(st.mu_init if mu0 is None else mu0).expand(B).clone()
        lam = w.new_zeros((B, m + q)) if lam0 is None else lam0
        z0v = st.z_init
        zl = torch.cat([torch.where(has_lb, z0v, 0.0),
                        torch.full((q,), z0v, dtype=dtype, device=device)]
                       ).expand(B, n + q)
        zu = torch.cat([torch.where(has_ub, z0v, 0.0),
                        torch.zeros((q,), dtype=dtype, device=device)]
                       ).expand(B, n + q)
        # warm entries the previous solve zeroed restart at z_init
        if zl0 is not None:
            zl = torch.where(zl0 > 1e-12, torch.maximum(zl0, _c(mu) / 1e8),
                             torch.where(mask_l, zl, 0.0))
        if zu0 is not None:
            zu = torch.where(zu0 > 1e-12, torch.maximum(zu0, _c(mu) / 1e8),
                             torch.where(mask_zu, zu, 0.0))
        gv0, hv0 = eval_all(w, p)
        theta0 = constraint_violation(gv0, hv0, s)
        theta0 = torch.where(torch.isfinite(theta0), theta0, 1.0)
        full = w.new_full((B,), inf)
        return IPMState(
            w=w, s=s, lam=lam, zl=zl, zu=zu, mu=mu,
            it=torch.zeros((B,), dtype=torch.int64, device=device),
            converged=torch.zeros((B,), dtype=torch.bool, device=device),
            kkt_err=full, prox=w.new_zeros((B,)), best=(w, s, lam, zl, zu),
            best_err=full,
            filt_th=w.new_full((B, st.filter_size), inf),
            filt_ph=w.new_full((B, st.filter_size), inf),
            filt_n=torch.zeros((B,), dtype=torch.int64, device=device),
            th_max=1e4 * torch.clamp(theta0, min=1.0),
            th_min=1e-4 * torch.clamp(theta0, min=1.0))

    # -- active-set Newton polish ------------------------------------------
    # A few full Newton steps with the active set FIXED (active bounds
    # pinned by a large quadratic penalty, inactive inequality multipliers
    # driven to zero) converge quadratically to the exact KKT point.
    BIG = 1e10

    def polish(w, s, lam, zl, zu, p):
        B = w.shape[0]
        dl_w = torch.where(has_lb, w - lb, inf)
        du_w = torch.where(has_ub, ub - w, inf)
        act_lb = has_lb & (zl[:, :n] > dl_w)
        act_ub = has_ub & (zu[:, :n] > du_w)
        act_h = (zl[:, n:] > s) if q else zl.new_zeros((B, 0), dtype=bool)
        act_b = act_lb | act_ub
        target = torch.where(act_ub, ub, torch.where(act_lb, lb, 0.0))
        target = torch.where(torch.isfinite(target), target, 0.0)
        zero = w.new_zeros((B,))
        w_, lam_ = w, lam
        for _ in range(3):
            lam_g, lam_h = lam_[:, :m], lam_[:, m:]
            r_dw = grad_f(w_, p) + jgT_mv(w_, p, lam_g) \
                + jhT_mv(w_, p, lam_h) \
                + BIG * torch.where(act_b, w_ - target, 0.0)
            r_g, hv = eval_all(w_, p)
            # active ineq -> equality (inv_sig 0); inactive -> lam -> 0
            inv_sig = torch.where(act_h, 0.0, BIG) if q else empty(w)
            r_h_mod = hv - lam_h * inv_sig
            sig_pol = torch.where(act_b, BIG, 0.0)
            if structured_solve is not None:
                ctx_ = structured_solve[0](w_, p, lam_g, lam_h, sig_pol,
                                           inv_sig)
                dw_, dg_, dh_ = structured_solve[1](ctx_, r_dw, r_g,
                                                    r_h_mod, zero)
            else:
                Jg_ = jac_g(w_, p) if m else w.new_zeros((B, 0, n))
                Jh_ = jac_h(w_, p) if q else w.new_zeros((B, 0, n))
                dw_, dg_, dh_ = solve_kkt(
                    hess_fn(w_, p, lam_g, lam_h), sig_pol, Jg_, Jh_,
                    inv_sig, r_dw, r_g, r_h_mod, zero)
            good = _all_finite(dw_, dg_, dh_)
            w_ = _sel(good, w_ + dw_, w_)
            lam_ = _sel(good, lam_ + torch.cat([dg_, dh_], -1), lam_)
        # bound duals and slacks consistent with the polished point
        lam_gp, lam_hp = lam_[:, :m], lam_[:, m:]
        r_stat = grad_f(w_, p) + jgT_mv(w_, p, lam_gp) \
            + jhT_mv(w_, p, lam_hp)
        zl_p = torch.cat([
            torch.where(act_lb, torch.clamp(r_stat, min=0.0), 0.0),
            torch.where(act_h, torch.clamp(lam_hp, min=0.0), 0.0)], -1)
        zu_p = torch.cat([
            torch.where(act_ub, torch.clamp(-r_stat, min=0.0), 0.0),
            w.new_zeros((B, q))], -1)
        w_cl = torch.minimum(torch.maximum(w_, torch.where(has_lb, lb, -inf)),
                             torch.where(has_ub, ub, inf))
        _, hv_p = eval_all(w_cl, p)
        s_p = torch.clamp(-hv_p, min=0.0)
        return w_cl, s_p, lam_, zl_p, zu_p

    def _select(cond, a, b):
        return tuple(_sel(cond, y, x) for x, y in zip(a, b))

    def solve_batch(w0, p, lam0, mu0, zl0, zu0):
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

    def solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None):
        def to(x):
            return None if x is None else torch.as_tensor(
                x, dtype=dtype, device=device)
        w0, p, lam0, zl0, zu0 = map(to, (w0, p, lam0, zl0, zu0))
        return solve_batch(w0, p, lam0, mu0, zl0, zu0)

    solve.newton_steps = 0
    return solve
