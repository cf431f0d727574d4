"""Orthogonal collocation coefficients (Radau / Legendre).

Replaces ``casadi.collocation_points`` + the symbolic Lagrange-polynomial
construction in the reference (do_mpc/optimizer.py:843-888) with direct numpy
computation of the collocation points, the derivative matrix C and the
continuity vector D.  Executed once at problem-construction time.
"""
from __future__ import annotations

import numpy as np


def collocation_points(deg: int, scheme: str = "radau") -> np.ndarray:
    """Collocation points in (0, 1], matching CasADi's convention.

    Radau: roots of the right-Radau polynomial (includes endpoint 1).
    Legendre: Gauss-Legendre points shifted to (0,1).
    """
    assert deg >= 1
    if scheme == "radau":
        # Right Radau IIA points: roots of P_{d}(2t-1) - P_{d-1}(2t-1) ... the
        # standard construction: interior roots of d/dt [t^{d-1} (t-1)^d] plus 1.
        # Equivalently: roots of the Jacobi polynomial P_{deg-1}^{(1,0)} shifted,
        # plus the endpoint 1.
        if deg == 1:
            pts = np.array([1.0])
        else:
            from numpy.polynomial import polynomial as P
            # roots of Jacobi polynomial P_{deg-1}^{(1,0)} on [-1,1]
            # use eigenvalue method via recurrence (Golub-Welsch)
            n = deg - 1
            alpha, beta = 1.0, 0.0
            # Jacobi recurrence coefficients
            j = np.arange(1, n)
            a0 = (beta - alpha) / (alpha + beta + 2.0)
            ak = (beta**2 - alpha**2) / (
                (2*j + alpha + beta) * (2*j + alpha + beta + 2))
            a_diag = np.concatenate([[a0], ak])
            j = np.arange(1, n)
            b1 = 4*(1+alpha)*(1+beta) / ((2+alpha+beta)**2 * (3+alpha+beta))
            bk = (4*j*(j+alpha)*(j+beta)*(j+alpha+beta) /
                  ((2*j+alpha+beta)**2 * (2*j+alpha+beta+1) *
                   (2*j+alpha+beta-1)))
            if n >= 2:
                b_off = np.sqrt(np.concatenate([[b1], bk[1:]]))
            else:
                b_off = np.array([])
            T = np.diag(a_diag)
            if n >= 2:
                T += np.diag(b_off, 1) + np.diag(b_off, -1)
            interior = np.sort(np.linalg.eigvalsh(T))
            pts = np.concatenate([(interior + 1.0) / 2.0, [1.0]])
    elif scheme == "legendre":
        interior, _ = np.polynomial.legendre.leggauss(deg)
        pts = np.sort((interior + 1.0) / 2.0)
    else:
        raise ValueError(f"unknown collocation scheme {scheme!r}")
    return pts


def lagrange_matrices(deg: int, scheme: str = "radau"):
    """Return (tau_root, C, D) as in the reference transcription
    (do_mpc/optimizer.py:854-888).

    tau_root: [0] + collocation points, length deg+1.
    C[j, r]:  dL_j/dtau evaluated at tau_root[r]  (derivative matrix).
    D[j]:     L_j(1)  (continuity/interpolation-to-endpoint vector).
    """
    tau = np.concatenate([[0.0], collocation_points(deg, scheme)])
    d1 = deg + 1
    C = np.zeros((d1, d1))
    D = np.zeros(d1)
    for j in range(d1):
        # Lagrange basis L_j as polynomial coefficients
        coeff = np.array([1.0])
        for r in range(d1):
            if r != j:
                coeff = np.convolve(coeff, np.array([1.0, -tau[r]]))
                coeff = coeff / (tau[j] - tau[r])
        D[j] = np.polyval(coeff, 1.0)
        dcoeff = np.polyder(coeff)
        for r in range(d1):
            C[j, r] = np.polyval(dcoeff, tau[r])
    return tau, C, D
