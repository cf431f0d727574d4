"""ODE/DAE integrators (PyTorch port of the JAX package's
``ops/integrators.py``).

Implicit Radau IIA collocation (stiff and index-1 DAE capable, order
2*deg-1) with full Newton on the stage system, ``torch.func.jacfwd`` for its
Jacobian and ``torch.linalg.solve_ex`` for the step; explicit RK4 for
non-stiff ODEs; the step-doubling adaptive Radau integrator that stands in
for the SUNDIALS CVODES/IDAS tolerances; and a Newton root finder.

Functions have the signature ``f(x, z, args) -> dx/dt`` and ``g(x, z, args)
-> algebraic residual`` on unbatched tensors; ``args`` is whatever the
caller closes over (u, tvp, p, w).  Tensors keep the dtype and device of
``x0``.

The JAX package's data-dependent ``lax.while_loop``s (the Newton iterations,
the adaptive time stepping) are host loops over device tensors here: every
pass reads its stopping test back to the host, one sync per Newton
iteration and per adaptive step.  The stopping rules are the JAX package's
exactly, so both take the same iterations and the same steps.
"""
from __future__ import annotations

import torch

from .collocation import lagrange_matrices
from ..optimizer import const_cache


def rk4_step(f, x, args, h):
    k1 = f(x, args)
    k2 = f(x + 0.5 * h * k1, args)
    k3 = f(x + 0.5 * h * k2, args)
    k4 = f(x + h * k3, args)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def make_ode_integrator(f, method="radau", substeps=1, deg=3, newton_iters=8,
                        newton_tol=1e-12):
    """Integrator for a pure ODE ``f(x, args) -> xdot`` over one interval h.

    Returns ``step(x0, args, h) -> x(h)``.
    """
    if method == "rk4":
        def step(x0, args, h):
            hs = h / substeps
            x = x0
            for _ in range(substeps):
                x = rk4_step(f, x, args, hs)
            return x
        return step

    def f_dae(x, z, args):
        return f(x, args)

    def g_dae(x, z, args):
        return x.new_zeros((0,))

    dae = make_dae_integrator(f_dae, g_dae, n_z=0, substeps=substeps,
                              deg=deg, newton_iters=newton_iters,
                              newton_tol=newton_tol)

    def step(x0, args, h):
        x, _ = dae(x0, x0.new_zeros((0,)), args, h)
        return x
    return step


def _newton(resid, y, iters, tol):
    """Full Newton on ``resid(y) = 0``: at most ``iters`` iterations, while
    max |dy| of the last step exceeds ``tol`` (a NaN step stops it)."""
    jac = torch.func.jacfwd(lambda yy: (lambda r: (r, r))(resid(yy)),
                            has_aux=True)
    err = None
    for _ in range(iters):
        if err is not None and not bool(err > tol):
            break
        J, r = jac(y)
        # (forward mode can promote a float32 Jacobian to float64: a 0-d
        # tensor times a Python float is taken as float64 under vmap)
        dy = torch.linalg.solve_ex(J.to(r.dtype), -r[:, None])[0][:, 0]
        y = y + dy
        err = dy.abs().max()
    return y


def make_radau_stage_solver(f, g, n_z, deg=3, newton_iters=8,
                            newton_tol=1e-12):
    """One implicit Radau IIA collocation step for an index-1 DAE.

    ``f(x, z, args) -> xdot``; ``g(x, z, args) -> residual (n_z,)``.
    Returns ``newton_solve(x0, z0, args, h) -> (x(h), z(h))``: with node
    values X_0=x0, X_1..X_s at the Radau points, require sum_r C[r,j] X_r =
    h f(X_j, Z_j) and g(X_j, Z_j) = 0, j=1..s; Radau includes the right
    endpoint, so x(h)=X_s and z(h)=Z_s.
    """
    _, C, _ = lagrange_matrices(deg, "radau")
    C_of = const_cache(C)
    s = deg  # number of unknown stages

    def stage_residual(xs_flat, x0, z_flat, args, h):
        nx = x0.shape[0]
        Cd = C_of(x0)
        X = xs_flat.reshape(s, nx)               # stages 1..s
        Z = z_flat.reshape(s, n_z) if n_z else x0.new_zeros((s, 0))
        Xall = torch.cat([x0[None, :], X], 0)    # (s+1, nx)
        res = []
        for j in range(1, s + 1):
            xp_j = torch.einsum("r,rn->n", Cd[:, j], Xall)  # poly derivative
            res.append(h * f(X[j - 1], Z[j - 1], args) - xp_j)
        if n_z:
            for j in range(1, s + 1):
                res.append(g(X[j - 1], Z[j - 1], args))
        return torch.cat(res)

    def newton_solve(x0, z0, args, h):
        nx = x0.shape[0]
        # initial guess: constant extrapolation
        y = torch.cat([x0.repeat(s), z0.repeat(s)])

        def resid(yy):
            return stage_residual(yy[:s * nx], x0, yy[s * nx:], args, h)

        y = _newton(resid, y, newton_iters, newton_tol)
        X_end = y[(s - 1) * nx: s * nx]
        Z_end = y[s * nx + (s - 1) * n_z:] if n_z else z0
        return X_end, Z_end

    return newton_solve


def make_dae_integrator(f, g, n_z, substeps=1, deg=3, newton_iters=8,
                        newton_tol=1e-12):
    """Fixed-substep Radau IIA integrator: ``step(x0, z0, args, h)``."""
    newton_solve = make_radau_stage_solver(f, g, n_z, deg=deg,
                                           newton_iters=newton_iters,
                                           newton_tol=newton_tol)

    def step(x0, z0, args, h):
        hs = h / substeps
        x, z = x0, z0
        for _ in range(substeps):
            x, z = newton_solve(x, z, args, hs)
        return x, z

    return step


def make_adaptive_dae_integrator(f, g, n_z, deg=3, abstol=1e-10,
                                 reltol=1e-10, newton_iters=12,
                                 init_substeps=4, max_steps=10_000):
    """Error-controlled Radau IIA integrator honoring abstol/reltol.

    Local error by step doubling (one step of h against two of h/2,
    Richardson factor 2^p - 1 with p = 2*deg - 1) and the I-controller
    h <- h * 0.9 * (1/err)^(1/(p+1)), the factor clipped to [0.2, 5], at
    most ``max_steps`` steps.  ``step.last_steps`` holds the number of
    steps (accepted and rejected) the last call took.

    Returns ``step(x0, z0, args, h_total) -> (x(h_total), z(h_total))``.
    """
    p_order = 2 * deg - 1
    newton_tol = max(min(abstol, reltol) * 1e-2, 1e-15)
    newton_solve = make_radau_stage_solver(f, g, n_z, deg=deg,
                                           newton_iters=newton_iters,
                                           newton_tol=newton_tol)
    rich = float(2 ** p_order - 1)

    def step(x0, z0, args, h_total):
        def T(v):
            return torch.as_tensor(v, dtype=x0.dtype, device=x0.device)

        # the dtype's achievable tolerance floor: asking float32 for 1e-10
        # leaves the step-doubling estimate saturated at rounding noise, so
        # steps would shrink toward max_steps; clamp to ~50 eps
        eps = torch.finfo(x0.dtype).eps
        abstol_e = torch.clamp(T(abstol), min=50 * eps)
        reltol_e = torch.clamp(T(reltol), min=50 * eps)
        t, h = T(0.0), T(h_total / init_substeps)
        x, z = x0, z0
        count = 0
        while count < max_steps and bool(t < h_total * (1.0 - 1e-12)):
            h_eff = torch.minimum(h, h_total - t)
            x1, _ = newton_solve(x, z, args, h_eff)        # single step
            xh, zh = newton_solve(x, z, args, 0.5 * h_eff)  # two half steps
            x2, z2 = newton_solve(xh, zh, args, 0.5 * h_eff)
            scale = abstol_e + reltol_e * torch.maximum(x.abs(), x2.abs())
            err = ((x2 - x1).abs() / scale).max() / rich
            err = torch.where(torch.isfinite(err), err, T(float("inf")))
            accept = err <= 1.0
            t = torch.where(accept, t + h_eff, t)
            x = torch.where(accept, x2, x)
            if n_z:
                z = torch.where(accept, z2, z)
            fac = 0.9 * torch.where(err > 0, err, T(1e-16)) \
                ** (-1.0 / (p_order + 1))
            fac = torch.clamp(torch.where(torch.isfinite(fac), fac, T(0.2)),
                              0.2, 5.0)
            h = torch.clamp(h_eff * fac, max=h_total)
            count += 1
        step.last_steps = count
        return x, z

    step.last_steps = 0
    return step


def newton_rootfind(g, z0, args, iters=20, tol=1e-12):
    """Solve g(z, args) = 0 for z by Newton (the root finder for discrete
    DAE models and consistent algebraic states)."""
    return _newton(lambda z: g(z, args), z0, iters, tol)
