"""The KKT error of a returned primal-dual point, in float64.

The solver certifies an instance when its scaled KKT error at barrier
parameter 0 is within the tolerance (IPOPT's optimality error, Wächter
and Biegler 2006, eq. 5, with s_max = 100).  This module works the error
out again from the reference transcription, for the point the program
returned: the problem ``min f(w)`` s.t. ``g(w) = 0``, ``h(w) + s = 0``,
``s >= 0``, ``lb <= w <= ub``, multipliers ``lam = [lam_g; lam_h]``, bound
duals ``zl`` (for w and s) and ``zu`` (for w).
"""
from __future__ import annotations

import torch


def kkt_error(tr, x0, w, s, lam, zl, zu, s_max=100.0):
    """Per-instance (err, err_d, err_p, err_c), float64 tensors (B,).

    ``tr`` is a :class:`~portbench.reference.ocp.Transcription`; every
    other argument is (B, ...) and is converted to float64 on its device.
    """
    f64 = torch.float64
    w, s, lam, zl, zu, x0 = (a.to(f64) for a in (w, s, lam, zl, zu, x0))
    n, m, q = tr.n, tr.m, tr.q
    dev = w.device
    lb = torch.as_tensor(tr.lb, dtype=f64, device=dev)
    ub = torch.as_tensor(tr.ub, dtype=f64, device=dev)
    has_lb, has_ub = torch.isfinite(lb), torch.isfinite(ub)

    wg = w.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        f, g, h = tr.functions(wg, x0)
        lag = f.sum() + (lam[:, :m] * g).sum()
        if q:
            lag = lag + (lam[:, m:] * h).sum()
        (grad,) = torch.autograd.grad(lag, wg)
    g, h = g.detach(), h.detach()

    r_dw = grad - torch.where(has_lb, zl[:, :n], 0.0) \
        + torch.where(has_ub, zu[:, :n], 0.0)
    r_ds = lam[:, m:] - zl[:, n:]
    r_p = torch.cat([g, h + s], -1)
    comp_l = torch.cat([torch.where(has_lb, (w - lb) * zl[:, :n], 0.0),
                        s * zl[:, n:]], -1)
    comp_u = torch.where(has_ub, (ub - w) * zu[:, :n], 0.0)
    z_sum = zl.abs().sum(-1) + zu.abs().sum(-1)
    lam_sum = lam.abs().sum(-1)
    s_d = torch.clamp((lam_sum + z_sum) / max(n + q + m, 1),
                      min=s_max) / s_max
    s_c = torch.clamp(z_sum / max(n + q, 1), min=s_max) / s_max

    def maxabs(x):
        return x.abs().amax(-1) if x.shape[-1] else x.new_zeros(x.shape[0])

    err_d = maxabs(torch.cat([r_dw, r_ds], -1)) / s_d
    err_p = maxabs(r_p)
    err_c = torch.maximum(maxabs(comp_l), maxabs(comp_u)) / s_c
    err = torch.maximum(torch.maximum(err_d, err_p), err_c)
    return err, err_d, err_p, err_c


def bound_violation(tr, w, s, zl, zu):
    """Per-instance largest violation of the point's sign conditions,
    float64 (B,): ``lb <= w <= ub`` where the bound is finite, relative to
    ``1 + |bound|``; ``s >= 0``; ``zl, zu >= 0``.  0 where all hold.

    :func:`kkt_error` reads complementarity by its absolute value, so a
    point outside a bound, or a bound dual of the wrong sign, is a KKT
    point only of another problem: this is the check that tells them
    apart."""
    f64 = torch.float64
    w, s, zl, zu = (a.to(f64) for a in (w, s, zl, zu))
    dev = w.device
    lb = torch.as_tensor(tr.lb, dtype=f64, device=dev)
    ub = torch.as_tensor(tr.ub, dtype=f64, device=dev)
    below = torch.where(torch.isfinite(lb), (lb - w) / (1.0 + lb.abs()),
                        0.0)
    above = torch.where(torch.isfinite(ub), (w - ub) / (1.0 + ub.abs()),
                        0.0)
    terms = torch.cat([below, above, -s, -zl, -zu], -1)
    return torch.clamp(terms.amax(-1), min=0.0)
