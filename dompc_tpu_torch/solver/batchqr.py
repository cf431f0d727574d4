"""Partitioned (SPIKE) block-tridiagonal chain solve (PyTorch port of the
JAX package's ``solver/batchqr.py:band_solve_spike_impl``).

A chain's sweep is sequential over its S stages.  SPIKE cuts each chain
into P segments of L stages separated by single separator stages, sweeps
all N*P segments at once (the two separator couplings ride along as 2b
extra right-hand-side columns), solves the small reduced system over the
P-1 separators with a second sweep, and recovers the segment interiors by
products, with no third sweep.  Both sweeps go through ``sweep``, by
default :func:`band_qr.band_solve`: the band-QR CUDA kernel for CUDA
tensors (two launches a solve), the plain sweep for CPU tensors.

Stage layout: the chain is padded with identity stages to
``P * (L + 1)`` stages, so that a view of shape (N, P, L + 1, ...) holds
segment i's interior at ``[:, i, :L]`` and the separator after it at
``[:, i, L]`` (the last separator slot is padding).  Gathers are views and
the solution is assembled with ``torch.cat``: no scatter.

The JAX package's other public names here compute the same functions
another way on this card: its batch-on-lanes dense QR solves
(``qr_solve_batched``, ``qr_solve``) are batched ``torch.linalg.solve_ex``
(LU), and its XLA lanes sweeps (``band_solve_qr_lanes``, ``band_solve``,
``band_solve_qr_lanes_wy``, ``band_solve_wy``) and ``band_solve_spike``
sweep with :func:`band_qr.band_solve`.  JAX's custom-vmap rules, which
flatten an outer batch into the chain batch, have no counterpart: the
port's sweeps take the chains batch-first.
"""
from __future__ import annotations

import torch

from . import band_qr


def band_solve_spike_impl(D, U, Lo, rhs, n_parts, sweep=None):
    """Block-tridiagonal solve with the stages cut into ``n_parts``
    segments.  D: (N, S, b, b); U, Lo: (N, S-1, b, b); rhs: (N, S, b, t).
    Returns (N, S, b, t).  ``sweep(D, U, Lo, rhs)`` solves chains (by
    default :func:`band_qr.band_solve`, looked up at each call)."""
    sweep = sweep or band_qr.band_solve
    N, S, b, _ = D.shape
    t = rhs.shape[-1]
    P = n_parts
    if P < 2 or S < 2 * P - 1:
        # fewer than one interior stage a segment: the plain sweep
        return sweep(D, U, Lo, rhs)
    L = -(-(S - (P - 1)) // P)           # ceil segment length
    M = P * (L + 1)                      # padded stages, one slot spare

    def pad(x, n, fill):
        return torch.cat([x, fill.expand((N, n) + x.shape[2:])], dim=1) \
            .view((N, P, L + 1) + x.shape[2:])

    zero_bb = D.new_zeros((1, 1, b, b))
    Dp = pad(D, M - S, torch.eye(b, dtype=D.dtype, device=D.device)[None,
                                                                    None])
    Up = pad(U, M - S + 1, zero_bb)
    Lp = pad(Lo, M - S + 1, zero_bb)
    rp = pad(rhs, M - S, rhs.new_zeros((1, 1, b, t)))

    zb = D.new_zeros((N, 1, b, b))
    leftC = torch.cat([zb, Lp[:, :P - 1, L]], dim=1)       # (N, P, b, b)
    rightC = torch.cat([Up[:, :P - 1, L - 1], zb], dim=1)
    zL = D.new_zeros((N, P, L - 1, b, b))
    aug = torch.cat([torch.cat([leftC[:, :, None], zL], dim=2),
                     torch.cat([zL, rightC[:, :, None]], dim=2),
                     rp[:, :, :L]], dim=-1)                # (N, P, L, b, 2b+t)

    def flat(x):
        return x.reshape((N * P,) + x.shape[2:]).contiguous()

    Y = sweep(flat(Dp[:, :, :L]), flat(Up[:, :, :L - 1]),
              flat(Lp[:, :, :L - 1]), flat(aug)) \
        .reshape(N, P, L, b, 2 * b + t)
    YL, YR, ys = Y[..., :b], Y[..., b:2 * b], Y[..., 2 * b:]

    # reduced block-tridiagonal system over the P-1 separators
    Lo_l = Lp[:, :P - 1, L - 1]                            # (N, P-1, b, b)
    U_r = Up[:, :P - 1, L]
    D_red = (Dp[:, :P - 1, L] - Lo_l @ YR[:, :P - 1, L - 1]
             - U_r @ YL[:, 1:, 0])
    U_red = -(U_r @ YR[:, 1:, 0])[:, :P - 2]
    Lo_red = -(Lo_l @ YL[:, :P - 1, L - 1])[:, 1:]
    b_red = (rp[:, :P - 1, L] - Lo_l @ ys[:, :P - 1, L - 1]
             - U_r @ ys[:, 1:, 0])
    x_sep = sweep(*(x.contiguous() for x in (D_red, U_red, Lo_red, b_red)))

    # interiors: x = y - YL x_leftsep - YR x_rightsep
    zt = rhs.new_zeros((N, 1, b, t))
    xs_l = torch.cat([zt, x_sep], dim=1)[:, :, None]       # (N, P, 1, b, t)
    xs_r = torch.cat([x_sep, zt], dim=1)
    x_seg = ys - YL @ xs_l - YR @ xs_r[:, :, None]
    x = torch.cat([x_seg, xs_r[:, :, None]], dim=2)        # (N, P, L+1, b, t)
    return x.reshape(N, M, b, t)[:, :S]


def qr_solve_batched(A, B):
    """Solve A_i x_i = B_i for a batch of small dense systems: A (..., n, n),
    B (..., n, t).  Batched ``torch.linalg.solve_ex``: a singular system
    gives non-finite values, as the JAX package's pivot-free QR does, and
    never raises."""
    return torch.linalg.solve_ex(A, B)[0]


# JAX's custom-vmap form of the same solve (solve_ex takes any leading
# batch axes)
qr_solve = qr_solve_batched


# the JAX package's column-at-a-time and blocked-WY lanes sweeps, with and
# without its custom-vmap rule: D (N, S, b, b), U and Lo (N, S-1, b, b),
# rhs (N, S, b, t), the band-QR kernel for CUDA tensors and the plain sweep
# for CPU tensors
band_solve_qr_lanes = band_solve = band_solve_wy = band_solve_qr_lanes_wy = \
    band_qr.band_solve


def band_solve_spike(D, U, Lo, rhs, n_parts=3, use_pallas=False):
    """:func:`band_solve_spike_impl` with :func:`band_qr.band_solve` as its
    sweep.  ``use_pallas`` (JAX: the Pallas or the XLA lanes segment sweep)
    chooses nothing here: both are ``band_qr.band_solve``."""
    del use_pallas
    return band_solve_spike_impl(D, U, Lo, rhs, n_parts)
