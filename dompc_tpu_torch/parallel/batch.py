"""Batched NMPC solves (PyTorch port of the JAX package's
``parallel/batch.py``).

One batch-first interior-point solve serves a whole batch of (x0, w0)
problem instances of one MPC: every iteration evaluates the B instances'
derivatives together and sweeps all their KKT chains in one band-kernel
launch.  Each instance's result is the one it would get alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver.ipm import IPMSettings, IPMSolution, make_ipm_solver


def initial_guess_from_x0(mpc, x0s):
    """Per-instance primal initial guess: broadcast each x0 into every state
    slot (the batched analogue of MPC.set_initial_guess).  numpy in, numpy
    out."""
    L = mpc.layout
    n = L.size
    xs = mpc._x_scaling.data
    map_x = -np.ones(n, int)
    for key in L.offsets:
        if key[0] == "x_node":
            map_x[L.sl(key)] = np.arange(mpc.model.n_x)
        elif key[0] == "x_coll":
            map_x[L.sl(key)] = np.tile(np.arange(mpc.model.n_x),
                                       mpc.n_total_coll_points)
    base = np.zeros(n)
    for key in L.offsets:
        if key[0] == "u":
            base[L.sl(key)] = mpc._u0.data / mpc._u_scaling.data
        elif key[0] == "z":
            nrep = L.sizes[key] // max(mpc.model.n_z, 1)
            base[L.sl(key)] = np.tile(
                mpc._z0.data / mpc._z_scaling.data, nrep)
    x0s = np.asarray(x0s, dtype=float)
    scaled = x0s / xs[None, :]
    w0s = np.tile(base, (x0s.shape[0], 1))
    mask = map_x >= 0
    w0s[:, mask] = scaled[:, map_x[mask]]
    return w0s


def make_batch_solver(mpc, tol=1e-6, max_iter=60, use_structured=True,
                      warm=True, throughput_mode=False, rti_iters=0,
                      chunk=None, **ipm_overrides):
    """Return ``solve_batch(x0s, w0s, lam0s=None, mu0=None, zl0s=None,
    zu0s=None) -> (sol, u0s)``: one batch-first solve over problem
    instances of the given (set-up) MPC, on its device and in its dtype.

    ``x0s``: (B, n_x) initial states; ``w0s``: (B, n_w_opt) primal initial
    guesses (e.g. :func:`initial_guess_from_x0`).  Returns the
    :class:`IPMSolution` with a leading batch axis and the per-instance
    first input u0 = w[u(0,0)] * scaling, (B, n_u).  Cold calls leave
    ``lam0s`` None; warm calls pass ``(lam0s, mu0, zl0s, zu0s)`` from a
    previous solution, ``mu0`` (scalar or (B,)) defaulting to the MPC's
    ``warm_start_mu``.

    ``throughput_mode`` drops the regularization ladder, the second-order
    correction, the polish and restoration, and takes one refinement pass
    in the float64 band solve (three otherwise) -- the JAX package's
    settings for large-batch moderate-tolerance solves.  ``chunk`` solves
    a batch as sequential sub-batches of ``chunk`` instances (B must be a
    multiple of it).  ``rti_iters`` other than 0 raises
    ``NotImplementedError`` (the RTI mode is not ported yet); ``warm`` is
    accepted for the JAX signature and unused there too.
    ``solve_batch.ipm`` is the underlying solver (its ``newton_steps``
    counts the batch's Newton steps).
    """
    st = mpc.settings
    if throughput_mode or rti_iters:
        kw = dict(tol=tol, max_iter=max_iter, reg_retries=0, use_soc=False,
                  do_polish=False, rti_iters=rti_iters, use_resto=False)
        kw.update(ipm_overrides)   # explicit overrides win
        ipm_settings = IPMSettings(**kw)
        n_refine = 1
    else:
        ipm_settings = IPMSettings(tol=tol, max_iter=max_iter,
                                   **ipm_overrides)
        n_refine = 3
    structured = None
    if use_structured and hasattr(mpc, "_struct_parts"):
        structured = mpc._make_kkt_backend(ipm_settings.delta_cons,
                                           n_refine=n_refine)
    solve = make_ipm_solver(
        mpc._f_fn, mpc._g_fn, mpc._h_fn,
        mpc._lb_opt_x, mpc._ub_opt_x,
        mpc.n_opt_lagr, mpc._n_ineq, settings=ipm_settings,
        hess_fn=mpc._hess_fn, grad_f_fn=mpc._grad_f_fn,
        jac_g_fn=mpc._jac_g_fn, jac_h_fn=mpc._jac_h_fn,
        structured_solve=structured, dtype=mpc._dtype, device=mpc._device)

    def T(x):
        """numpy, a scalar or a tensor -> the MPC's dtype and device."""
        if torch.is_tensor(x):
            return x.to(device=mpc._device, dtype=mpc._dtype)
        return mpc._tensor(x)

    base_pvec = T(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)))
    x0_sl = mpc._p_sl["x0"]
    u_sl = mpc.layout.sl(("u", 0, 0))
    u_scaling = T(mpc._u_scaling.data)
    n_zl = mpc.n_opt_x + mpc._n_ineq

    def solve_batch(x0s, w0s, lam0s=None, mu0=None, zl0s=None, zu0s=None):
        B = x0s.shape[0]
        if chunk and B > chunk:
            assert B % chunk == 0, (
                f"batch {B} must be a multiple of chunk {chunk}")
            outs = []
            for i in range(0, B, chunk):
                sl = slice(i, i + chunk)
                outs.append(solve_batch(
                    x0s[sl], w0s[sl],
                    None if lam0s is None else lam0s[sl],
                    mu0 if (mu0 is None or np.ndim(mu0) == 0) else mu0[sl],
                    None if zl0s is None else zl0s[sl],
                    None if zu0s is None else zu0s[sl]))
            sols, u0s = zip(*outs)
            sol = IPMSolution(*(torch.cat(xs) for xs in zip(*sols)))
            return sol, torch.cat(u0s)
        pvec = base_pvec.expand(B, -1).clone()
        pvec[:, x0_sl] = T(x0s)
        if lam0s is None:
            # cold: the solver's own initialization (the JAX package runs
            # it through the warm program with the cold multipliers, the
            # same arithmetic, to save a compile)
            sol = solve(T(w0s), pvec)
        else:
            if mu0 is None:
                mu0 = st.warm_start_mu
            if zl0s is None:
                # zeros fall through init_state's z_init default per entry
                zl0s = torch.zeros((B, n_zl))
                zu0s = torch.zeros((B, n_zl))
            sol = solve(T(w0s), pvec, T(lam0s), T(mu0), T(zl0s), T(zu0s))
        return sol, sol.w[:, u_sl] * u_scaling

    solve_batch.ipm = solve
    return solve_batch


def make_shift_fn(mpc):
    """Receding-horizon warm-start shift for batched solutions.

    Returns ``shift(sol) -> (w, lam, zl, zu)`` advancing an IPMSolution by
    one stage along the nominal scenario branch (last stage duplicated),
    the acados-style RTI warm start.  Works on (B, ...) batches or single
    vectors (indexes the last axis)."""
    maps = mpc._build_shift_maps()

    def shift(sol):
        dev = sol.w.device
        iw, il, iz = (torch.as_tensor(maps[k], device=dev)
                      for k in ("w", "lam", "z"))
        return (sol.w[..., iw], sol.lam[..., il],
                sol.zl[..., iz], sol.zu[..., iz])

    return shift
