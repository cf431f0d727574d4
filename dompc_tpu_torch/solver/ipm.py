"""Primal-dual interior-point NLP solver (PyTorch port), batch-first.

Counterpart of the JAX package's ``solver/ipm.py``: Fiacco-McCormick
barrier loop with exact-Hessian primal-dual Newton steps, the
Wächter-Biegler (theta, phi) filter line search (or the l1-merit
backtracking of ``globalization="merit"``), second-order correction, the
regularization ladder capped at ``prox_max``, the dual trust region
``dual_cap``, select-gated feasibility restoration (``use_resto``), the
best-iterate watchdog, the active-set Newton polish, the least-squares
dual estimate of ``cold_dual_init``, the multiplier refit of
``dual_refit``, KKT-level iterative refinement (``n_refine_kkt``), the
real-time-iteration modes and per-solve bound values
(``dynamic_bounds``).

Problem form:

    min_w f(w, p)   s.t.  g(w, p) = 0,  h(w, p) <= 0,  lb <= w <= ub

Every state field has a leading batch axis (B,): B instances are solved in
lockstep, each exactly as it would be alone.  These are the semantics of
``jax.vmap`` over the JAX solver: its ``lax.while_loop`` becomes a Python
loop that runs while any element is unfinished, and elements that are
finished are frozen by ``torch.where``; ``_cond_any`` (skip a branch when
no element needs it) is a host-side ``if`` on the predicate's ``any()``.
``MPC.make_step`` solves with B=1.

The solve runs under the spans of ``tools/_profiler.py:SPANS``: ``ipm.*``
around its phases, ``oracle.point`` around every evaluation of the
problem functions at a point (on CUDA replayed as a captured graph from a
shape's second evaluation on, ``solver/_graphs.py``), and ``sync.<site>``
around every blocking read of the device (``profiler.any_true``,
``profiler.to_device``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from .._config import resolve_device, resolve_dtype
from ..tools import _profiler as profiler
from ._graphs import GraphCache


@dataclass(frozen=True)
class IPMSettings:
    """The JAX package's ``IPMSettings``, with the same defaults (see there
    for the reasoning behind each).  ``debug`` prints the per-iteration
    diagnostics on the host, one line per batch element."""
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
    lam_init_max: float = 1e4   # reject larger LS dual estimates (lam = 0)
    dual_cap: float = 1e2
    prox_max: float = 1e4
    s_max: float = 100.0
    debug: bool = False
    reg_retries: int = 5
    use_soc: bool = True
    do_polish: bool = True
    rti_iters: int = 0          # >0: real-time iteration on warm calls
    rti_prox: float = 1e-3      # fixed Levenberg damping of RTI steps
    rti_step_max: float = 10.0  # trust-region cap: |dw|_inf * alpha <= this
    dual_refit: bool = False
    refit_delta: float = 1e8    # proximal weight of the refit solve
    rti_drift_tol: float | None = None  # bounded-drift RTI band
    rti_extra_max: int = 6      # cap on drift-correction iterations
    rti_filter: bool = False    # filter-RTI hybrid (capped globalized loop)
    rti_mu_decay: float = 0.1   # per-RTI-iteration barrier decrease
    n_refine_kkt: int = 0


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
        rti_prox=getattr(st, "solver_rti_prox", 1e-3),
        rti_step_max=getattr(st, "solver_rti_step_max", 10.0),
        rti_mu_decay=getattr(st, "solver_rti_mu_decay", 0.1),
        rti_drift_tol=getattr(st, "solver_rti_drift_tol", None),
        rti_filter=getattr(st, "solver_rti_filter", False),
        rti_extra_max=getattr(st, "solver_rti_extra_max", 6),
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


def _cond_any(site, pred, true_fn, false_val):
    """Run ``true_fn`` only when some element's predicate holds (the JAX
    package's zero-trip ``while_loop``, here a host-side ``if`` on a read
    of the device in span ``sync.<site>``)."""
    return true_fn() if profiler.any_true(site, pred) else false_val


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


def _debug(fmt, **vals):
    """``IPMSettings.debug``: print ``fmt`` on the host once per batch
    element, with element ``i`` of each (B,) value (scalars as given)."""
    def read(v):
        with profiler.host_sync("debug"):
            return v.detach().cpu().reshape(-1).tolist() if v.ndim \
                else v.item()
    rows = {k: (read(v) if torch.is_tensor(v) else v)
            for k, v in vals.items()}
    B = max((len(v) for v in rows.values() if isinstance(v, list)),
            default=1)
    for i in range(B):
        print(("" if B == 1 else f"[{i}] ") + fmt.format(**{
            k: (v[i] if isinstance(v, list) else v)
            for k, v in rows.items()}), flush=True)


def _argmaxabs(x):
    return x.abs().argmax(-1) if x.shape[-1] else \
        torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)


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
    graphs=None,
):
    """Build ``solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None,
    lb_dyn=None, ub_dyn=None) -> IPMSolution``.

    ``w0`` (B, n) with ``p`` (B, n_p) solves B instances in lockstep, each
    as it would be solved alone; the solution's fields keep the batch axis
    (``iterations`` is a per-element tensor).  ``mu0`` is a scalar or (B,).
    ``solve.newton_steps`` counts the Newton steps the batch took (one per
    loop pass in which some element was unconverged, and one per RTI
    step, corrective ones included).  With ``rti_iters > 0`` a warm call
    (``lam0`` given) takes the real-time-iteration path; a cold one runs
    the globalized loop.

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

    ``solve.graphs`` is the ``GraphCache`` of its point evaluations
    (``solver/_graphs.py``): the ``graphs`` given, which the structured
    backend's derivative oracles evaluate through too
    (``Optimizer._make_solver``), or else one of its own.

    ``dynamic_bounds=True`` lets a call pass per-element bound values
    ``lb_dyn``/``ub_dyn`` (B, n), as branch-and-bound's node batches do;
    which entries are bounded at all stays that of the static ``lb``/``ub``.
    The same solver serves every call: the bounds are values of the call,
    handed to each helper that reads them, and no point evaluation reads
    them.
    ``solve.lb``/``solve.ub`` are the static bounds as given, and
    ``solve.n_bound_duals`` the width of ``zl0``/``zu0``: one dual for each
    of the n variables and the ``n_ineq`` slacks.
    """
    st = settings
    if st.globalization not in ("filter", "merit"):
        raise ValueError(f"globalization must be 'filter' or 'merit', got "
                         f"{st.globalization!r}")
    device = resolve_device() if device is None else torch.device(device)
    dtype = resolve_dtype() if dtype is None else dtype

    def T(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    static_bounds = (lb, ub)
    lb, ub = T(lb), T(ub)
    n = lb.shape[-1]
    m, q = n_eq, n_ineq
    has_lb, has_ub = torch.isfinite(lb), torch.isfinite(ub)
    filter_mode = st.globalization == "filter"
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

    def eval_all_(w, p):
        return (g(w, p) if m else empty(w)), (h(w, p) if q else empty(w))

    # Jacobian-vector products (used instead of materialized Jacobians
    # wherever possible, and exclusively in structured mode).  Row b of a
    # batched g depends on row b of w only, so one vjp/jvp over the batch
    # is the per-element product.
    def jgT_mv_(w, p, lam):
        if not m:
            return torch.zeros_like(w)
        return torch.func.vjp(lambda ww: g(ww, p), w)[1](lam)[0]

    def jhT_mv_(w, p, nu):
        if not q:
            return torch.zeros_like(w)
        return torch.func.vjp(lambda ww: h(ww, p), w)[1](nu)[0]

    def jg_mv_(w, p, dx):
        if not m:
            return empty(w)
        return torch.func.jvp(lambda ww: g(ww, p), (w,), (dx,))[1]

    def jh_mv_(w, p, dx):
        if not q:
            return empty(w)
        return torch.func.jvp(lambda ww: h(ww, p), (w,), (dx,))[1]

    def hvp_(w, p, lam_g, lam_h, dx):
        """Lagrangian Hessian-vector product via jvp of the gradient."""
        def lag_grad(ww):
            return (grad_f(ww, p) + jgT_mv_(ww, p, lam_g)
                    + jhT_mv_(ww, p, lam_h))
        return torch.func.jvp(lag_grad, (w,), (dx,))[1]

    def point_evals_(w, lam, p):
        """(gradient, residuals, J^T lam) shared by the KKT-error check and
        the Newton step at the same point."""
        gf = grad_f(w, p)
        gv, hv = eval_all_(w, p)
        jtl = jgT_mv_(w, p, lam[:, :m]) + jhT_mv_(w, p, lam[:, m:])
        return gf, gv, hv, jtl

    graphs = GraphCache() if graphs is None else graphs

    def at_point(fn):
        """``fn`` as one IPM-level evaluation of the problem functions (span
        ``oracle.point``), replayed as a captured CUDA graph where the
        solver's ``GraphCache`` can (``solver/_graphs.py``).  The functions
        ending in ``_`` are the bare ones, for composites that open one span
        of their own and for code under a ``torch.func`` transform."""
        def evaluated(*args):
            with profiler.span("oracle.point"):
                return graphs(fn, args)
        return evaluated

    (f_at, grad_f_at, eval_all, jgT_mv, jhT_mv, jg_mv, jh_mv, lag_hvp,
     point_evals) = map(at_point, (f, grad_f, eval_all_, jgT_mv_, jhT_mv_,
                                   jg_mv_, jh_mv_, hvp_, point_evals_))

    # -- barrier helpers over the combined (w bounds, s >= 0) --------------
    # ``bnd`` is a call's (lb, ub): the static (n,) bounds, or a
    # dynamic-bounds call's (B, n) values; has_lb/has_ub stay the static
    # masks
    def dist_l(w, s, bnd):
        return torch.where(has_lb, w - bnd[0], 1.0), s  # slack lb is 0

    def dist_u(w, bnd):
        return torch.where(has_ub, bnd[1] - w, 1.0)

    def barrier_value(w, s, p, mu, bnd):
        val = f_at(w, p)
        dl, du = dist_l(w, s, bnd)[0], dist_u(w, bnd)
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
    mask_l = torch.cat([has_lb, ones_q])
    mask_zu = torch.cat([has_ub, zeros_qb])

    def kkt_residuals(w, s, lam, zl, zu, p, bnd, pre=None):
        """Mu-independent residual summary (one evaluation serves
        err_mu / err_0 / err_{mu_new})."""
        gf, gv, hv, jtl = pre if pre is not None else point_evals(
            w, lam, p)
        r_dw = gf + jtl
        r_dw = r_dw - torch.where(has_lb, zl[:, :n], 0.0) \
            + torch.where(has_ub, zu[:, :n], 0.0)
        r_ds = (lam[:, m:] - zl[:, n:]) if q else empty(w)
        r_p = torch.cat([gv, hv + s], -1)
        dl_w, dl_s = dist_l(w, s, bnd)
        du_w = dist_u(w, bnd)
        comp_l = torch.cat([torch.where(has_lb, dl_w * zl[:, :n], 0.0),
                            dl_s * zl[:, n:]], -1)
        comp_u = torch.where(has_ub, du_w * zu[:, :n], 0.0)
        z_sum = zl.abs().sum(-1) + zu.abs().sum(-1)
        lam_sum = lam.abs().sum(-1)
        denom = n + q + m
        s_d = torch.clamp((lam_sum + z_sum) / max(denom, 1),
                          min=st.s_max) / st.s_max
        s_c = torch.clamp(z_sum / max(n + q, 1), min=st.s_max) / st.s_max
        r_d_all = torch.cat([r_dw, r_ds], -1)
        err_d = _maxabs(r_d_all) / s_d
        err_p = _maxabs(r_p)
        if st.debug:
            _debug("   kkt: err_d={ed:.2e}@{ia} (n={n}) err_p={ep:.2e}@{ip}",
                   ed=err_d, ia=_argmaxabs(r_d_all), n=n, ep=err_p,
                   ip=_argmaxabs(r_p))
        return err_d, err_p, comp_l, comp_u, s_c

    def err_from(res, mu):
        err_d, err_p, comp_l, comp_u, s_c = res
        c_l = torch.where(mask_l, comp_l - _c(mu), 0.0)
        c_u = torch.where(has_ub, comp_u - _c(mu), 0.0)
        err_c = torch.maximum(_maxabs(c_l), _maxabs(c_u)) / s_c
        return torch.maximum(torch.maximum(err_d, err_p), err_c)

    def kkt_error(w, s, lam, zl, zu, p, mu, bnd):
        return err_from(kkt_residuals(w, s, lam, zl, zu, p, bnd), mu)

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
    def newton_step(w, s, lam, zl, zu, p, mu, prox, pre, live, bnd):
        """``live`` (B,): the elements whose step is used; host-side skips
        look at those only (the others' results are discarded)."""
        B = w.shape[0]
        lam_g, lam_h = lam[:, :m], lam[:, m:]
        gf, gv, hv, jtl = pre

        dl_w, dl_s = dist_l(w, s, bnd)
        du_w = dist_u(w, bnd)
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
            return profiler.to_device("delta", delta, dtype, device).expand(B)

        if structured_solve is not None:
            # derivatives + assembly once per Newton step; the retry ladder
            # and the second-order correction reuse the assembled system
            s_prepare, s_solve = structured_solve
            with profiler.span("kkt.prepare"):
                kkt_ctx = s_prepare(w, p, lam_g, lam_h, sig_w, inv_sig_s)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                with profiler.span("kkt.solve"):
                    return s_solve(kkt_ctx, r_dw_, r_g_, r_h_mod_,
                                   bvec(delta))

            def hvp(dx, _lg=lam_g, _lh=lam_h):
                # the multipliers of the assembled Hessian: the dual refit
                # below rebinds lam_g/lam_h, but the operator of the
                # residual and curvature checks must be the factored one
                return lag_hvp(w, p, _lg, _lh, dx)
        else:
            Jg = jac_g(w, p) if m else w.new_zeros((B, 0, n))
            Jh = jac_h(w, p) if q else w.new_zeros((B, 0, n))
            Hw = hess_fn(w, p, lam_g, lam_h)

            def do_solve_rhs(r_dw_, r_g_, r_h_mod_, delta):
                return solve_kkt(Hw, sig_w, Jg, Jh, inv_sig_s, r_dw_, r_g_,
                                 r_h_mod_, bvec(delta))

            def hvp(dx):
                return (Hw @ dx[..., None])[..., 0]

        # least-squares multiplier refit (dual_refit): one solve with a
        # dominant primal proximal weight returns dlam ~ -(J J^T)^-1 J r_dw,
        # applied at full step before the Newton direction is computed (the
        # caller adds dlam_pre outside the alpha-scaled update)
        dlam_pre = w.new_zeros((B, m + q))
        if st.dual_refit and (m + q):
            _, dgr, dhr = do_solve_rhs(
                r_dw, w.new_zeros((B, m)),
                (-r_ds * inv_sig_s) if q else empty(w), st.refit_delta)
            ok_r = _all_finite(dgr, dhr)
            dgr = _sel(ok_r, dgr, torch.zeros_like(dgr))
            dhr = _sel(ok_r, dhr, torch.zeros_like(dhr))
            dlam_pre = torch.cat([dgr, dhr], -1)
            lam_g = lam_g + dgr
            lam_h = lam_h + dhr
            r_dw = gf + jgT_mv(w, p, lam_g) + jhT_mv(w, p, lam_h) \
                - torch.where(has_lb, _c(mu) / dl_w, 0.0) \
                + torch.where(has_ub, _c(mu) / du_w, 0.0)
            r_ds = lam_h - _c(mu) / dl_s if q else empty(w)
            r_h_mod = r_h - r_ds * inv_sig_s

        def do_solve(delta):
            return do_solve_rhs(r_dw, r_g, r_h_mod, delta)

        rhs_norm = torch.maximum(torch.maximum(_maxabs(r_dw), _maxabs(r_g)),
                                 _maxabs(r_h_mod)) + 1e-12

        def step_residuals(step, delta, Hd):
            """The true residual of a step, by the matrix-free operator."""
            dw_, dg_, dh_ = step
            res_w = (Hd + (sig_w + _c(delta)) * dw_ + r_dw
                     + jgT_mv(w, p, dg_) + jhT_mv(w, p, dh_))
            res_g = (jg_mv(w, p, dw_) - st.delta_cons * dg_ + r_g) if m \
                else r_g
            res_h = (jh_mv(w, p, dw_) - inv_sig_s * dh_
                     - st.delta_cons * dh_ + r_h_mod) if q else r_h_mod
            return res_w, res_g, res_h

        def step_residual(step, delta, Hd):
            res_w, res_g, res_h = step_residuals(step, delta, Hd)
            return torch.maximum(torch.maximum(_maxabs(res_w),
                                               _maxabs(res_g)),
                                 _maxabs(res_h))

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
            if not profiler.any_true("ladder", bad):
                break
            delta = torch.clamp(torch.clamp(prox, min=1e-8) * mult,
                                max=st.prox_max)
            step = tuple(_sel(bad, new, old)
                         for new, old in zip(do_solve(delta), step))
            prev_delta = torch.where(bad, delta, prev_delta)

        # KKT-level iterative refinement (n_refine_kkt): re-solve the same
        # factored system with the true residual of the step, formed in the
        # state dtype by the matrix-free operator (the mixed-precision
        # recipe below the float32 solve's noise floor)
        for _ in range(st.n_refine_kkt):
            res = tuple(r.to(w.dtype) for r in step_residuals(
                step, prev_delta, hvp(step[0])))
            corr = do_solve_rhs(*res, prev_delta)
            ok_c = _all_finite(*corr)
            step = tuple(_sel(ok_c, a + c, a) for a, c in zip(step, corr))

        dw, dlam_g, dlam_h = step
        # non-finite guard: zero the step and escalate the Levenberg prox
        step_ok = _all_finite(dw, dlam_g, dlam_h)
        dw = _sel(step_ok, dw, torch.zeros_like(dw))
        dlam_g = _sel(step_ok, dlam_g, torch.zeros_like(dlam_g))
        dlam_h = _sel(step_ok, dlam_h, torch.zeros_like(dlam_h))
        prev_delta = torch.where(step_ok, prev_delta,
                                 torch.clamp(prox, min=1e-8) * 100.0)
        if st.debug:
            _debug("  newton: |dw|={dwn:.2e}@{i} delta={d:.1e} res={r:.2e}",
                   dwn=_maxabs(dw), i=_argmaxabs(dw), d=prev_delta,
                   r=step_residual(step, prev_delta, hvp(step[0])))

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
                                                   dlam_pre, resolve_resto)

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

    def fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu, mu, bnd):
        tau = _c(torch.clamp(1.0 - mu, min=st.tau_min))
        dl_w, dl_s = dist_l(w, s, bnd)
        du_w = dist_u(w, bnd)
        a_p = max_alpha(w, dw, tau * dl_w, has_lb)
        a_p = torch.minimum(a_p, max_alpha(w, -dw, tau * du_w, has_ub))
        if q:
            a_p = torch.minimum(a_p, max_alpha(s, ds, tau * dl_s, ones_q))
        return a_p, dual_alpha(zl, zu, dzl, dzu, mu)

    def clip_duals(w, s, zl, zu, mu, bnd):
        """Keep the bound duals sane relative to the barrier (IPOPT's
        kappa_Sigma): within [mu/(kap d), kap mu/d] of their distances d;
        the upper duals only where an upper bound exists."""
        kap = 1e10
        dl_w, dl_s = dist_l(w, s, bnd)
        dl = torch.clamp(torch.cat([dl_w, dl_s], -1), min=_TINY)
        zl = torch.minimum(torch.maximum(zl, _c(mu) / (kap * dl)),
                           kap * _c(mu) / dl)
        du = torch.clamp(torch.cat([dist_u(w, bnd),
                                    torch.full_like(s, inf)], -1), min=_TINY)
        zu = torch.where(
            mask_zu, torch.minimum(torch.maximum(zu, _c(mu) / (kap * du)),
                                   kap * _c(mu) / du), 0.0)
        return zl, zu

    # -- main loop ----------------------------------------------------------
    slots = torch.arange(st.filter_size, device=device)

    def take_step(stt, p, pre, res0, err_mu, live, bnd):
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

        with profiler.span("ipm.newton"):
            (dw, ds, dlam, dzl, dzu, resolve_soc, delta_used, dlam_pre,
             resolve_resto) = newton_step(w, s, lam, zl, zu, p, mu_new,
                                          stt.prox, pre, live, bnd)
        # the multiplier refit is part of the point, not of the searched
        # direction: applied at full step, outside the alpha-scaled update
        lam_b = lam + dlam_pre
        if filter_mode:
            # dual trust region: primal acceptance cannot see multiplier
            # explosions, so bound them here
            dl_norm = _maxabs(dlam)
            l_norm = _maxabs(lam_b)
            dlam = dlam * _c(torch.clamp(st.dual_cap * (1.0 + l_norm)
                                         / torch.clamp(dl_norm, min=_TINY),
                                         max=1.0))
        a_p, a_d = fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu,
                                        mu_new, bnd)
        # the l1 merit's penalty
        nu = torch.clamp(2.0 * _maxabs(lam_b + dlam), min=1.0)
        err_ref = err_from(res0, mu_new)

        def kkt_decrease(alpha, dw_, ds_, dlam_, dzl_, dzu_, a_d_):
            err_t = kkt_error(w + _c(alpha) * dw_, s + _c(alpha) * ds_,
                              lam_b + _c(alpha) * dlam_,
                              zl + _c(a_d_) * dzl_, zu + _c(a_d_) * dzu_, p,
                              mu_new, bnd)
            return torch.isfinite(err_t) & (err_t < 0.99 * err_ref)

        def ls_trial(alpha, dw_, ds_):
            """The l1-merit acceptance test at one step size
            (``globalization="merit"``)."""
            s_t = s + _c(alpha) * ds_
            w_t = w + _c(alpha) * dw_
            phi = barrier_value(w_t, s_t, p, mu_new, bnd)
            gv_t, hv_t = eval_all(w_t, p)
            vio = constraint_violation(gv_t, hv_t, s_t)
            merit0 = phi_k + nu * theta_k
            merit = phi + nu * vio
            return torch.isfinite(merit) & (
                (merit <= merit0 - 1e-8 * alpha
                 * torch.clamp(theta_k, min=1e-16))
                | (vio <= theta_k * (1 - 1e-4 * alpha))
                | (merit <= merit0 + 1e-12 * merit0.abs()))

        def gphi_dot(dw_, ds_):
            """Directional derivative of the barrier objective."""
            dlw_, dls_ = dist_l(w, s, bnd)
            duw_ = dist_u(w, bnd)
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
            phi_t = barrier_value(w_t, s_t, p, mu_new, bnd)
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

        # the line search: the full-step acceptance test (filter or l1
        # merit), the KKT-decrease test, SOC and the backtracking loop,
        # through restoration, to the chosen step size
        with profiler.span("ipm.line_search"):
            theta_k = constraint_violation(pre[1], pre[2], s)
            phi_k = barrier_value(w, s, p, mu_new, bnd)

            # full step if acceptable; else one second-order correction;
            # else backtracking.  KKT-error decrease is an OR-acceptance that
            # counts as f-type; it only matters where the filter test is not
            # already an f-type acceptance, so it is computed when some
            # element needs it and selected.
            if filter_mode:
                acc0, ft0 = accept_fn(a_p, dw, ds, gphi_dot(dw, ds))
            else:
                acc0 = ls_trial(a_p, dw, ds)
                ft0 = torch.ones_like(acc0)
            need_kd = ~(acc0 & ft0)
            kd0 = _cond_any("kkt_decrease", need_kd & live,
                            lambda: kkt_decrease(a_p, dw, ds, dlam, dzl, dzu,
                                                 a_d),
                            torch.zeros_like(acc0))
            kd0 = torch.where(need_kd, kd0, True)
            ok_full = acc0 | kd0
            f_type = ft0 | kd0

            def do_soc():
                dw2, ds2, dlam2, dzl2, dzu2 = resolve_soc(a_p)
                a_p2, a_d2 = fraction_to_boundary(w, s, dw2, ds2, zl, zu,
                                                  dzl2, dzu2, mu_new, bnd)
                kd2 = kkt_decrease(a_p2, dw2, ds2, dlam2, dzl2, dzu2, a_d2)
                if filter_mode:
                    acc2, ft2 = accept_fn(a_p2, dw2, ds2, gphi_dot(dw2, ds2))
                else:
                    acc2 = ls_trial(a_p2, dw2, ds2)
                    ft2 = torch.ones_like(acc2)
                return (acc2 | kd2, ft2 | kd2, dw2, ds2, dlam2, dzl2, dzu2,
                        a_p2, a_d2)

            no_soc = (torch.zeros_like(ok_full), torch.ones_like(ok_full), dw,
                      ds, dlam, dzl, dzu, a_p, a_d)
            if st.use_soc:
                (soc_ok, soc_ft, dw2, ds2, dlam2, dzl2, dzu2, a_p2,
                 a_d2) = _cond_any("soc", ~ok_full & live, do_soc, no_soc)
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

            if filter_mode:
                # filter backtracking line search, seeded with the full-step
                # decision: accepted elements take zero trips, and it runs
                # while some element is unfinished, finished elements frozen
                # (the JAX while_loop under vmap)
                gphi_d = gphi_dot(dw, ds)
                gneg = -torch.clamp(gphi_d, max=0.0)
                amin2 = torch.where(
                    gneg > 0,
                    st.gamma_phi * theta_k / torch.clamp(gneg, min=_TINY),
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
                    go = ~ls_done & (k < st.ls_max) \
                        & (alpha * 0.5 >= alpha_min)
                    if not profiler.any_true("line_search", go & live):
                        break
                    a_try = alpha * 0.5
                    ok_t, ft_t = accept_fn(a_try, dw, ds, gphi_d)
                    alpha = torch.where(go, a_try, alpha)
                    f_type = torch.where(go, ft_t, f_type)
                    ls_done = ls_done | (go & ok_t)
                    k = k + go
                ls_failed = ~ls_done
                alpha = torch.where(ls_failed, 0.0, alpha)

                # -- feasibility restoration -------------------------------
                # a failed line search takes a minimum-norm step onto the
                # linearized constraints (backtracked on theta alone);
                # failures at an already feasible point take the alpha_min
                # fallback step
                use_resto = ls_failed & (theta_k > 1e-12) if st.use_resto \
                    else torch.zeros_like(ls_failed)

                def do_resto():
                    dwr, dsr, _, dzlr, dzur = resolve_resto()
                    fin = _all_finite(dwr, dsr, dzlr, dzur)
                    dwr = _sel(fin, dwr, torch.zeros_like(dwr))
                    dsr = _sel(fin, dsr, torch.zeros_like(dsr))
                    dzlr = _sel(fin, dzlr, torch.zeros_like(dzlr))
                    dzur = _sel(fin, dzur, torch.zeros_like(dzur))
                    a_pr, a_dr = fraction_to_boundary(
                        w, s, dwr, dsr, zl, zu, dzlr, dzur, mu_new, bnd)
                    al, r_ok = a_pr, ~use_resto
                    for _ in range(12):
                        go = ~r_ok
                        if not profiler.any_true("resto_search", go & live):
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
                    _cond_any("resto", use_resto & live, do_resto, zero_r) \
                    if st.use_resto else zero_r
                use_resto = use_resto & r_ok
                alpha = torch.where(use_resto, 0.0, alpha)
                # fallback for unrestorable failures: the alpha_min step keeps
                # strictly positive progress
                fallback = ls_failed & ~use_resto
                alpha = torch.where(
                    fallback,
                    torch.maximum(alpha_min, a_p * 0.5 ** st.ls_max), alpha)

        if not filter_mode:
            return merit_update(stt, p, mu_new, a_p, a_d, ok_full | use_soc,
                                dw, ds, lam_b, dlam, dzl, dzu, delta_used,
                                ls_trial, live, filt_th0, filt_ph0, filt_n0,
                                bnd)

        w_n = w + _c(alpha) * dw
        s_n = s + _c(alpha) * ds
        # select-gated, not multiplicative: 0 * NaN = NaN
        w_n = _sel(use_resto, w_n + _c(al_r) * dwr, w_n)
        s_n = _sel(use_resto, s_n + _c(al_r) * dsr, s_n)
        lam_n = lam_b + _c(alpha) * dlam
        eff_ad = torch.where(use_resto, a_dr, a_d)
        zl_n = zl + _c(eff_ad) * _sel(use_resto, dzlr, dzl)
        zu_n = zu + _c(eff_ad) * _sel(use_resto, dzur, dzu)
        zl_c, zu_c = clip_duals(w_n, s_n, zl_n, zu_n, mu_new, bnd)

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
        if st.debug:
            debug_iteration(stt, p, mu_new, res0, pre, alpha, a_d, nu, dlam,
                            w, s, dw, ds, bnd)
        return (w_n, s_n, lam_n, zl_c, zu_c, mu_new, prox_n, filt_th1,
                filt_ph1, filt_n1)

    def merit_update(stt, p, mu_new, a_p, a_d, done, dw, ds, lam_b, dlam,
                     dzl, dzu, delta_used, ls_trial, live, filt_th0,
                     filt_ph0, filt_n0, bnd):
        """The rest of a ``globalization="merit"`` iteration: backtracking
        on the l1 merit (seeded with the full-step decision ``done``), no
        restoration, and the Levenberg adaptation of the legacy rule."""
        w, s, zl, zu = stt.w, stt.s, stt.zl, stt.zu
        with profiler.span("ipm.line_search"):
            alpha = a_p
            k = torch.zeros_like(stt.it)
            while True:
                go = ~done & (k < st.ls_max)
                if not profiler.any_true("line_search", go & live):
                    break
                a_try = alpha * 0.5
                ok_t = ls_trial(a_try, dw, ds)
                alpha = torch.where(go, a_try, alpha)
                done = done | (go & ok_t)
                k = k + go
            # a failed search takes a tiny step (keeps progress in the batch)
            alpha = torch.where(done, alpha, a_p * 0.5 ** st.ls_max)
        w_n = w + _c(alpha) * dw
        s_n = s + _c(alpha) * ds
        lam_n = lam_b + _c(alpha) * dlam
        zl_c, zu_c = clip_duals(w_n, s_n, zl + _c(a_d) * dzl,
                                zu + _c(a_d) * dzu, mu_new, bnd)
        # small accepted steps -> more damping; good steps -> less
        prox_n = torch.where(
            alpha < 0.1, torch.clamp(delta_used * 10.0, min=1e-8),
            torch.where(alpha > 0.9, delta_used / 5.0, delta_used))
        prox_n = torch.clamp(prox_n, 0.0, st.prox_max)
        if st.debug:
            nu = torch.clamp(2.0 * _maxabs(lam_b + dlam), min=1.0)
            debug_iteration(stt, p, mu_new, None, None, alpha, a_d, nu,
                            dlam, w, s, dw, ds, bnd)
        return (w_n, s_n, lam_n, zl_c, zu_c, mu_new, prox_n, filt_th0,
                filt_ph0, filt_n0)

    def debug_iteration(stt, p, mu_new, res0, pre, alpha, a_d, nu, dlam,
                        w, s, dw, ds, bnd):
        """``IPMSettings.debug``: the step's blocking bound and the
        iteration's summary line."""
        tau = _c(torch.clamp(1.0 - mu_new, min=st.tau_min))
        dlw, dls = dist_l(w, s, bnd)
        duw = dist_u(w, bnd)
        rat = torch.minimum(
            torch.where(has_lb & (dw < 0),
                        -tau * dlw / torch.where(dw == 0, -1.0, dw), inf),
            torch.where(has_ub & (dw > 0),
                        tau * duw / torch.where(dw == 0, 1.0, dw), inf))
        blk = rat.argmin(-1)
        pick = (lambda x: x.gather(-1, blk[:, None])[:, 0])
        s_rat = (torch.where(ds < 0, -tau * dls / torch.where(
            ds == 0, -1.0, ds), inf).amin(-1) if q else inf)
        _debug("   blocker: w[{b}] rat={r:.2e} dw={dwb:.2e} dl={dlb:.2e} "
               "du={dub:.2e} s_min_rat={sr:.2e}", b=blk, r=pick(rat),
               dwb=pick(dw), dlb=pick(dlw), dub=pick(duw), sr=s_rat)
        if pre is None:
            pre = point_evals(w, stt.lam, p)
            res0 = kkt_residuals(w, s, stt.lam, stt.zl, stt.zu, p, bnd,
                                 pre=pre)
        _debug("it={it} mu={mu:.1e} err0={e0:.2e} errmu={em:.2e} d={ed:.1e} "
               "p={ep:.1e} phi={ph:.8e} th={th:.2e} alpha={a:.2e} "
               "a_d={ad:.2e} nu={nu:.1e} |dlam|={dl:.1e} |lam|={l:.1e} "
               "prox={px:.1e}", it=stt.it, mu=mu_new,
               e0=err_from(res0, 0.0), em=err_from(res0, stt.mu),
               ed=res0[0], ep=res0[1], ph=barrier_value(w, s, p, mu_new, bnd),
               th=constraint_violation(pre[1], pre[2], s), a=alpha, ad=a_d,
               nu=nu, dl=_maxabs(dlam), l=_maxabs(stt.lam), px=stt.prox)

    def body(stt, p, active, etol, bnd):
        """One loop pass; the caller keeps its results for ``active``
        elements only.  An element whose KKT error is within ``etol``
        converges."""
        w, s, lam, zl, zu = stt.w, stt.s, stt.lam, stt.zl, stt.zu
        with profiler.span("ipm.evals"):
            pre = point_evals(w, lam, p)
            res0 = kkt_residuals(w, s, lam, zl, zu, p, bnd, pre=pre)
            err_0 = err_from(res0, 0.0)
            converged = err_0 <= etol
        old = (w, s, lam, zl, zu, stt.mu, stt.prox, stt.filt_th,
               stt.filt_ph, stt.filt_n)
        live = active & ~converged
        if profiler.any_true("live", live):
            # a converged element is frozen (the JAX body computes its
            # step and discards it); it leaves the loop after this pass
            with profiler.span("ipm.step"):
                new = take_step(stt, p, pre, res0, err_from(res0, stt.mu),
                                live, bnd)
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

    loop_tol = st.tol if st.tol_loop is None else max(st.tol_loop, st.tol)

    def solver_loop(state, p, bnd, it_cap=None, exit_tol=None):
        """The globalized loop.  ``it_cap``/``exit_tol`` parametrize the
        filter-RTI hybrid (a small iteration budget, the drift band as the
        exit); the defaults are the full loop's."""
        cap = st.max_iter if it_cap is None else it_cap
        etol = loop_tol if exit_tol is None else exit_tol
        while True:
            active = ~state.converged & (state.it < cap)
            if not profiler.any_true("loop", active):
                return state
            state = freeze(active, body(state, p, active, etol, bnd),
                           state)

    # -- real-time iteration: fixed Newton steps from a warm start ----------
    # Exactly rti_iters damped Newton steps (no line search, no barrier
    # schedule, no convergence loop), then, with rti_drift_tol, corrective
    # steps while an element's true KKT error is outside the band.  Each
    # element leaves the corrective loop on its own and is frozen there (a
    # vmapped while_loop in the JAX package): a data-dependent host loop
    # with one sync per pass.
    def rti_newton(stt, p, mu, live, bnd):
        w, s, lam, zl, zu = stt.w, stt.s, stt.lam, stt.zl, stt.zu
        with profiler.span("ipm.evals"):
            pre = point_evals(w, lam, p)
        with profiler.span("ipm.newton"):
            (dw, ds, dlam, dzl, dzu, _soc, _delta, dlam_pre,
             _resto) = newton_step(w, s, lam, zl, zu, p, mu,
                                   torch.clamp(stt.prox, min=st.rti_prox),
                                   pre, live, bnd)
        solve.newton_steps += 1
        lam = lam + dlam_pre
        a_p, a_d = fraction_to_boundary(w, s, dw, ds, zl, zu, dzl, dzu, mu,
                                        bnd)
        # trust-region cap: scale the whole primal-dual update uniformly
        cap = torch.clamp(st.rti_step_max / (_maxabs(dw) + 1e-12), max=1.0)
        a_p = torch.minimum(a_p, cap)
        a_d = torch.minimum(a_d, cap)
        w_n = w + _c(a_p) * dw
        s_n = s + _c(a_p) * ds
        zl_n, zu_n = clip_duals(w_n, s_n, zl + _c(a_d) * dzl,
                                zu + _c(a_d) * dzu, mu, bnd)
        return stt._replace(w=w_n, s=s_n, lam=lam + _c(a_p) * dlam, zl=zl_n,
                            zu=zu_n, it=stt.it + 1)

    def rti_loop(state, p, bnd):
        every = torch.ones_like(state.converged)
        final = state
        with profiler.span("ipm.rti"):
            for i in range(st.rti_iters):
                final = rti_newton(final, p, state.mu * st.rti_mu_decay ** i,
                                   every, bnd)
        err = kkt_error(final.w, final.s, final.lam, final.zl, final.zu, p,
                        0.0, bnd)
        if st.rti_drift_tol is None:
            return final._replace(kkt_err=err, converged=err <= st.tol)
        mu_ex = torch.clamp(state.mu * st.rti_mu_decay ** st.rti_iters,
                            min=st.tol * st.mu_min_factor)
        final = final._replace(kkt_err=err)
        k = torch.zeros_like(state.it)
        with profiler.span("ipm.rti_drift"):
            while True:
                go = (final.kkt_err > st.rti_drift_tol) \
                    & (k < st.rti_extra_max)
                if not profiler.any_true("rti_drift", go):
                    break
                nxt = rti_newton(final, p, mu_ex, go, bnd)
                nxt = nxt._replace(kkt_err=kkt_error(
                    nxt.w, nxt.s, nxt.lam, nxt.zl, nxt.zu, p, 0.0, bnd))
                final = freeze(go, nxt, final)
                k = k + go.to(k.dtype)
        return final._replace(
            converged=final.kkt_err <= max(st.rti_drift_tol, st.tol))

    def init_state(w0, p, bnd, lam0=None, mu0=None, zl0=None, zu0=None):
        B = w0.shape[0]
        lb, ub = bnd
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
        mu = profiler.to_device("mu0", st.mu_init if mu0 is None else mu0,
                                dtype, device).expand(B).clone()
        lam = w.new_zeros((B, m + q)) if lam0 is None else lam0
        z0v = st.z_init
        zl = torch.cat([torch.where(has_lb, z0v, 0.0),
                        torch.full((q,), z0v, dtype=dtype, device=device)]
                       ).expand(B, n + q)
        zu = torch.cat([torch.where(has_ub, z0v, 0.0),
                        torch.zeros((q,), dtype=dtype, device=device)]
                       ).expand(B, n + q)
        # warm entries the previous solve zeroed restart at z_init; pure RTI
        # restarts them on the central path, min(z_init, mu/dist) (the
        # globalized loop and the filter-RTI hybrid keep z_init, as in the
        # JAX package, which measured both choices)
        use_central = st.rti_iters > 0 and not st.rti_filter
        if zl0 is not None:
            restart_l = zl
            if use_central:
                dl_w0, dl_s0 = dist_l(w, s, bnd)
                restart_l = torch.clamp(
                    _c(mu) / torch.clamp(torch.cat([dl_w0, dl_s0], -1),
                                         min=1e-8), max=z0v)
            zl = torch.where(zl0 > 1e-12, torch.maximum(zl0, _c(mu) / 1e8),
                             torch.where(mask_l, restart_l, 0.0))
        if zu0 is not None:
            restart_u = zu
            if use_central:
                du0 = torch.cat([dist_u(w, bnd), w.new_ones((B, q))], -1)
                restart_u = torch.clamp(
                    _c(mu) / torch.clamp(du0, min=1e-8), max=z0v)
            zu = torch.where(zu0 > 1e-12, torch.maximum(zu0, _c(mu) / 1e8),
                             torch.where(mask_zu, restart_u, 0.0))
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

    def estimate_duals(w, s, zl, zu, p, mu, bnd):
        """Least-squares multipliers for a cold solve (``cold_dual_init``,
        IPOPT's least_square_init_duals analogue): one proximal-weighted
        KKT solve at lam = 0.  An estimate that is not finite or exceeds
        ``lam_init_max`` falls back to lam = 0, element by element."""
        B = w.shape[0]
        dl_w, dl_s = dist_l(w, s, bnd)
        dl_w = torch.clamp(dl_w, min=_TINY)
        du_w = torch.clamp(dist_u(w, bnd), min=_TINY)
        dl_s = torch.clamp(dl_s, min=_TINY)
        sig_w = torch.where(has_lb, zl[:, :n] / dl_w, 0.0) \
            + torch.where(has_ub, zu[:, :n] / du_w, 0.0)
        inv_sig_s = dl_s / torch.clamp(zl[:, n:], min=_TINY) if q \
            else empty(w)
        r_dw = grad_f_at(w, p) - torch.where(has_lb, _c(mu) / dl_w, 0.0) \
            + torch.where(has_ub, _c(mu) / du_w, 0.0)
        r_h_ls = (_c(mu) / dl_s) * inv_sig_s if q else empty(w)
        zero_g, zero_h = w.new_zeros((B, m)), w.new_zeros((B, q))
        delta = profiler.to_device("delta", st.refit_delta, dtype,
                                   device).expand(B)
        if structured_solve is not None:
            with profiler.span("kkt.prepare"):
                ctx = structured_solve[0](w, p, zero_g, zero_h, sig_w,
                                          inv_sig_s)
            with profiler.span("kkt.solve"):
                _, dg, dh = structured_solve[1](ctx, r_dw, zero_g, r_h_ls,
                                                delta)
        else:
            Jg = jac_g(w, p) if m else w.new_zeros((B, 0, n))
            Jh = jac_h(w, p) if q else w.new_zeros((B, 0, n))
            _, dg, dh = solve_kkt(hess_fn(w, p, zero_g, zero_h), sig_w, Jg,
                                  Jh, inv_sig_s, r_dw, zero_g, r_h_ls, delta)
        lam_ls = torch.cat([dg, dh], -1)
        # a garbage estimate from a degenerate start must not be worse than
        # the plain lam = 0 start
        ok = _all_finite(lam_ls) & (_maxabs(lam_ls) < st.lam_init_max)
        if st.debug:
            _debug("  estimate_duals: raw|lam|={l:.2e} finite={f} "
                   "|r_dw|={r:.2e}", l=_maxabs(lam_ls),
                   f=_all_finite(lam_ls), r=_maxabs(r_dw))
        return _sel(ok, lam_ls, torch.zeros_like(lam_ls))

    # -- active-set Newton polish ------------------------------------------
    # A few full Newton steps with the active set FIXED (active bounds
    # pinned by a large quadratic penalty, inactive inequality multipliers
    # driven to zero) converge quadratically to the exact KKT point.
    BIG = 1e10

    def polish(w, s, lam, zl, zu, p, bnd):
        B = w.shape[0]
        lb, ub = bnd
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
            r_dw = grad_f_at(w_, p) + jgT_mv(w_, p, lam_g) \
                + jhT_mv(w_, p, lam_h) \
                + BIG * torch.where(act_b, w_ - target, 0.0)
            r_g, hv = eval_all(w_, p)
            # active ineq -> equality (inv_sig 0); inactive -> lam -> 0
            inv_sig = torch.where(act_h, 0.0, BIG) if q else empty(w)
            r_h_mod = hv - lam_h * inv_sig
            sig_pol = torch.where(act_b, BIG, 0.0)
            if structured_solve is not None:
                with profiler.span("kkt.prepare"):
                    ctx_ = structured_solve[0](w_, p, lam_g, lam_h, sig_pol,
                                               inv_sig)
                with profiler.span("kkt.solve"):
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
        r_stat = grad_f_at(w_, p) + jgT_mv(w_, p, lam_gp) \
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

    def solve_rti(state, p, bnd):
        """A warm call in RTI mode (``_solve_impl``'s RTI branch of the JAX
        package)."""
        if st.rti_filter:
            # filter-RTI hybrid: the globalized body with a small budget;
            # without rti_drift_tol the exit is tol (as in JAX)
            etol = st.tol if st.rti_drift_tol is None \
                else max(st.rti_drift_tol, st.tol)
            cap = st.rti_iters + (st.rti_extra_max
                                  if st.rti_drift_tol is not None else 0)
            final = solver_loop(state, p, bnd, it_cap=cap, exit_tol=etol)
            with profiler.span("ipm.finish"):
                # the budget exit leaves final.w one step past the last
                # evaluated error: certify on the better evaluated point
                err_fin = kkt_error(final.w, final.s, final.lam, final.zl,
                                    final.zu, p, 0.0, bnd)
                wd = final.best_err < err_fin
                w_r, s_r, lam_r, zl_r, zu_r = _select(
                    wd, (final.w, final.s, final.lam, final.zl, final.zu),
                    final.best)
                err_r = torch.where(wd, final.best_err, err_fin)
                return IPMSolution(
                    w=w_r, s=s_r, lam=lam_r, zl=zl_r, zu=zu_r,
                    f=f_at(w_r, p), kkt_err=err_r, iterations=final.it,
                    success=err_r <= etol)
        final = rti_loop(state, p, bnd)
        with profiler.span("ipm.finish"):
            return IPMSolution(
                w=final.w, s=final.s, lam=final.lam, zl=final.zl,
                zu=final.zu, f=f_at(final.w, p), kkt_err=final.kkt_err,
                iterations=final.it, success=final.converged)

    def finish(final, p, bnd):
        """The solution from the loop's final state: the watchdog's choice,
        and the polish where it is on."""
        # a loose tol_loop exit certifies only at tol
        strict = final.converged if loop_tol <= st.tol \
            else final.converged & (final.kkt_err <= st.tol)
        cur = (final.w, final.s, final.lam, final.zl, final.zu)
        if not st.do_polish:
            # watchdog: ties return the evaluated best tuple (final.w is
            # one step past the last evaluated error on a max_iter exit)
            wd = final.best_err <= final.kkt_err
            w_r, s_r, lam_r, zl_r, zu_r = _select(wd, cur, final.best)
            err_r = torch.where(wd, final.best_err, final.kkt_err)
            return IPMSolution(
                w=w_r, s=s_r, lam=lam_r, zl=zl_r, zu=zu_r, f=f_at(w_r, p),
                kkt_err=err_r, iterations=final.it,
                success=strict | (err_r <= st.tol))
        # watchdog: polish whichever of (final state, best-seen iterate)
        # has the smaller true KKT error
        err_fin = kkt_error(*cur, p, 0.0, bnd)
        wd = final.best_err < err_fin
        start = _select(wd, cur, final.best)
        err_ipm = torch.where(wd, final.best_err, err_fin)
        with profiler.span("ipm.polish"):
            pol = polish(*start, p, bnd)
        err_pol = kkt_error(*pol, p, 0.0, bnd)
        if st.debug:
            _debug("polish: err_ipm={a:.2e} err_pol={b:.2e}", a=err_ipm,
                   b=err_pol)
        better = torch.isfinite(err_pol) & (err_pol < err_ipm)
        w_f, s_f, lam_f, zl_f, zu_f = _select(better, start, pol)
        err_f = torch.where(better, err_pol, err_ipm)
        return IPMSolution(
            w=w_f, s=s_f, lam=lam_f, zl=zl_f, zu=zu_f, f=f_at(w_f, p),
            kkt_err=err_f, iterations=final.it,
            success=strict | (err_f <= st.tol))

    def solve_batch(w0, p, lam0, mu0, zl0, zu0, bnd):
        with profiler.span("ipm.init"):
            state = init_state(w0, p, bnd, lam0=lam0, mu0=mu0, zl0=zl0,
                               zu0=zu0)
            if st.cold_dual_init and (m + q) and st.rti_iters == 0:
                # cold elements (lam all zero) start from the least-squares
                # multipliers; warm ones keep theirs
                cold = _maxabs(state.lam) == 0.0
                lam_ls = _cond_any("dual_init", cold, lambda: estimate_duals(
                    state.w, state.s, state.zl, state.zu, p, state.mu, bnd),
                    torch.zeros_like(state.lam))
                lam_n = _sel(cold, lam_ls, state.lam)
                if st.debug:
                    _debug("cold_dual_init: pred={p} |lam_ls|={l:.2e}",
                           p=cold, l=_maxabs(lam_ls))
                state = state._replace(lam=lam_n, best=(
                    state.w, state.s, lam_n, state.zl, state.zu))
        # RTI needs a warm primal-dual start: a cold call (no lam0) runs
        # the full globalized loop
        if st.rti_iters > 0 and lam0 is not None:
            return solve_rti(state, p, bnd)
        final = solver_loop(state, p, bnd)
        with profiler.span("ipm.finish"):
            return finish(final, p, bnd)

    def solve(w0, p, lam0=None, mu0=None, zl0=None, zu0=None, lb_dyn=None,
              ub_dyn=None):
        def to(site, x):
            return None if x is None else profiler.to_device(
                site, x, dtype, device)
        w0, p, lam0, zl0, zu0, lb_dyn, ub_dyn = map(
            to, ("w0", "p", "lam0", "zl0", "zu0", "bounds", "bounds"),
            (w0, p, lam0, zl0, zu0, lb_dyn, ub_dyn))
        if lb_dyn is None and ub_dyn is None:
            return solve_batch(w0, p, lam0, mu0, zl0, zu0, (lb, ub))
        if not dynamic_bounds:
            raise ValueError("pass dynamic_bounds=True to make_ipm_solver "
                             "to use lb_dyn/ub_dyn")
        return solve_batch(w0, p, lam0, mu0, zl0, zu0, (
            lb if lb_dyn is None else torch.where(has_lb, lb_dyn, lb),
            ub if ub_dyn is None else torch.where(has_ub, ub_dyn, ub)))

    solve.newton_steps = 0
    solve.graphs = graphs
    solve.lb, solve.ub = static_bounds
    solve.n_bound_duals = n + q
    return solve
