"""Direct block-band assembly of the OCP KKT system (PyTorch port of the
JAX package's ``solver/structured.py``).

The stage-block-tridiagonal KKT system is assembled directly from
instance-local derivative tensors into band tensors D (diag), U (super) and
L (sub) of shape (S, b, b) by precomputed static index maps, and solved by
a sequential block-LU sweep over the S stages (``lu_factor_ex`` /
``lu_solve``) or by banded block QR.  Plain torch on the tensors' device
and dtype, with loops over stages where JAX scans.  As in the JAX package,
no solve path calls this module: the MPC's KKT goes through ``bbd.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .band_qr import band_solve_qr_multi
from .bbd import band_matvec as _band_matvec


class BlockAssembler:
    """Precomputes static scatter maps (numpy) from instance-local tensors
    into the stage-band KKT representation."""

    def __init__(self, w_stage, g_stage, h_stage, inst_stage, A_all,
                 R_g, R_h, n, m, q, init_cols):
        w_stage = np.asarray(w_stage, int)
        g_stage = np.asarray(g_stage, int)
        h_stage = np.asarray(h_stage, int)
        inst_stage = np.asarray(inst_stage, int)
        S = int(max(w_stage.max(initial=0), g_stage.max(initial=0),
                    h_stage.max(initial=0))) + 1
        self.S = S
        self.n, self.m, self.q = n, m, q
        I, d = A_all.shape
        E = R_g.shape[1]
        nlr = R_h.shape[1] if q else 0

        # local positions: rows of stage k are ordered [w_k, lam_g_k, lam_h_k]
        w_loc = np.zeros(n, int)
        g_loc = np.zeros(m, int)
        h_loc = np.zeros(q, int)
        sizes = np.zeros(S, int)
        for k in range(S):
            c = 0
            wi = np.nonzero(w_stage == k)[0]
            w_loc[wi] = np.arange(len(wi))
            c += len(wi)
            gi = np.nonzero(g_stage == k)[0]
            g_loc[gi] = c + np.arange(len(gi))
            c += len(gi)
            hi = np.nonzero(h_stage == k)[0]
            h_loc[hi] = c + np.arange(len(hi))
            c += len(hi)
            sizes[k] = c
        b = int(sizes.max()) + 1          # last slot = trash
        self.b = b
        tr = b - 1

        # column maps for the extended instance vector (cols >= n: params)
        col_stage = np.where(A_all < n, w_stage[np.minimum(A_all, n - 1)],
                             inst_stage[:, None])
        col_loc = np.where(A_all < n, w_loc[np.minimum(A_all, n - 1)], tr)

        band_sz = S * b * b
        self.T_size = 3 * band_sz + 1
        garbage = self.T_size - 1

        def flat_idx(band, slot, r, c):
            return band * band_sz + (slot * b + r) * b + c

        def pair_idx(r_stage, r_loc, c_stage, c_loc):
            """Map (row, col) global position to flat band index."""
            ds = c_stage - r_stage
            same = flat_idx(0, r_stage, r_loc, c_loc)
            up = flat_idx(1, r_stage, r_loc, c_loc)
            dn = flat_idx(2, np.maximum(r_stage - 1, 0), r_loc, c_loc)
            out = np.where(ds == 0, same,
                           np.where(ds == 1, up,
                                    np.where(ds == -1, dn, garbage)))
            return out

        # Hessian scatter: (I, d, d)
        self.h_idx = pair_idx(
            col_stage[:, :, None], col_loc[:, :, None],
            col_stage[:, None, :], col_loc[:, None, :]).astype(np.int32)

        # Jacobian scatter (both the (lam,w) and symmetric (w,lam) entries)
        g_row_stage = g_stage[R_g]            # (I, E)
        g_row_loc = g_loc[R_g]
        self.jg_idx = pair_idx(
            g_row_stage[:, :, None], g_row_loc[:, :, None],
            col_stage[:, None, :], col_loc[:, None, :]).astype(np.int32)
        self.jg_idx_T = pair_idx(
            col_stage[:, None, :], col_loc[:, None, :],
            g_row_stage[:, :, None], g_row_loc[:, :, None]).astype(np.int32)
        if q:
            h_row_stage = h_stage[R_h]
            h_row_loc = h_loc[R_h]
            self.jh_idx = pair_idx(
                h_row_stage[:, :, None], h_row_loc[:, :, None],
                col_stage[:, None, :], col_loc[:, None, :]).astype(np.int32)
            self.jh_idx_T = pair_idx(
                col_stage[:, None, :], col_loc[:, None, :],
                h_row_stage[:, :, None], h_row_loc[:, :, None]).astype(
                np.int32)
        else:
            self.jh_idx = self.jh_idx_T = np.zeros((I, 0, d), np.int32)

        # diagonal entries
        self.w_diag_idx = flat_idx(0, w_stage, w_loc, w_loc).astype(np.int32)
        self.g_diag_idx = flat_idx(0, g_stage, g_loc, g_loc).astype(np.int32)
        self.h_diag_idx = flat_idx(0, h_stage, h_loc, h_loc).astype(np.int32)

        # initial-condition rows: identity between the first nx equality
        # rows and the given columns
        nx0 = len(init_cols)
        r_st, r_lc = g_stage[:nx0], g_loc[:nx0]
        c_st, c_lc = w_stage[init_cols], w_loc[init_cols]
        self.init_idx = np.concatenate([
            pair_idx(r_st, r_lc, c_st, c_lc),
            pair_idx(c_st, c_lc, r_st, r_lc)]).astype(np.int32)

        # rhs scatter / solution gather positions (within (S, b))
        self.w_pos = (w_stage * b + w_loc).astype(np.int32)
        self.g_pos = (g_stage * b + g_loc).astype(np.int32)
        self.h_pos = (h_stage * b + h_loc).astype(np.int32)
        # unused padding slots (between the real block size and the trash
        # slot) need identity diagonal entries
        pad_diag = np.zeros((S, b))
        for k in range(S):
            pad_diag[k, sizes[k]:b - 1] = 1.0
        self.pad_diag = pad_diag

    def _scatter(self, T, idx, vals):
        """Deterministic scatter-add of ``vals`` into the flat band at the
        static positions ``idx`` (repeated positions summed)."""
        idx = torch.as_tensor(np.asarray(idx).reshape(-1), device=T.device,
                              dtype=torch.long)
        T.index_put_((idx,), vals.reshape(-1), accumulate=True)

    def assemble(self, H_i, Jg_i, Jh_i, sig_w_delta, g_diag, h_diag):
        """Build (D, U, L) band tensors from instance tensors.

        H_i: (I, d, d); Jg_i: (I, E, d); Jh_i: (I, nlr, d);
        sig_w_delta: (n,) diagonal for w rows; g_diag: (m,); h_diag: (q,).
        """
        S, b = self.S, self.b
        T = H_i.new_zeros(self.T_size)
        self._scatter(T, self.h_idx, H_i)
        self._scatter(T, self.jg_idx, Jg_i)
        self._scatter(T, self.jg_idx_T, Jg_i)
        if self.q:
            self._scatter(T, self.jh_idx, Jh_i)
            self._scatter(T, self.jh_idx_T, Jh_i)
        self._scatter(T, self.init_idx, T.new_ones(len(self.init_idx)))
        self._scatter(T, self.w_diag_idx, sig_w_delta)
        self._scatter(T, self.g_diag_idx, g_diag)
        if self.q:
            self._scatter(T, self.h_diag_idx, h_diag)

        band_sz = S * b * b
        D = T[:band_sz].reshape(S, b, b).clone()
        U = T[band_sz:2 * band_sz].reshape(S, b, b).clone()
        Lo = T[2 * band_sz:3 * band_sz].reshape(S, b, b).clone()
        tr = b - 1
        # scrub trash row/col and pin its diagonal
        for M in (D, U, Lo):
            M[:, tr, :] = 0.0
            M[:, :, tr] = 0.0
        D[:, tr, tr] = 1.0
        # identity diagonal on unused padding slots
        D = D + torch.diag_embed(torch.as_tensor(self.pad_diag, dtype=D.dtype,
                                                 device=D.device))
        # U slot k holds (stage k rows, stage k+1 cols); L slot k holds
        # (stage k+1 rows, stage k cols): both use slots 0..S-2
        return D, U[:-1], Lo[:-1]

    def _pos(self, pos, device):
        return torch.as_tensor(pos, device=device, dtype=torch.long)

    def pack_rhs(self, r_w, r_g, r_h):
        S, b = self.S, self.b
        rhs = r_w.new_zeros(S * b)
        rhs[self._pos(self.w_pos, rhs.device)] = r_w
        rhs[self._pos(self.g_pos, rhs.device)] = r_g
        if self.q:
            rhs[self._pos(self.h_pos, rhs.device)] = r_h
        return rhs.reshape(S, b)

    def unpack_sol(self, x):
        flat = x.reshape(-1)
        dw = flat[self._pos(self.w_pos, x.device)]
        dg = flat[self._pos(self.g_pos, x.device)]
        dh = flat[self._pos(self.h_pos, x.device)] if self.q \
            else x.new_zeros(0)
        return dw, dg, dh


def band_matvec(D, U, Lo, x):
    """(S,b) result of the block-tridiagonal operator applied to x (S,b)."""
    return _band_matvec(D[None], U[None], Lo[None],
                        x[None, :, :, None])[0, :, :, 0]


def band_factor(D, U, Lo):
    """Sequential block LU: the LU factors of the Schur diagonal blocks, as
    ``(LU (S,b,b), pivots (S,b))`` of ``torch.linalg.lu_factor_ex``
    (LAPACK's 1-based pivots; JAX's ``lu_factor`` gives them 0-based)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(D[0])
    LUs, pivs = [LU], [piv]
    for k in range(1, D.shape[0]):
        X = torch.linalg.lu_solve(LU, piv, U[k - 1])
        LU, piv, _ = torch.linalg.lu_factor_ex(D[k] - Lo[k - 1] @ X)
        LUs.append(LU)
        pivs.append(piv)
    return torch.stack(LUs), torch.stack(pivs)


def band_solve_qr(D, U, Lo, rhs):
    """Stable pivot-free block-tridiagonal solve by sequential block QR
    (banded QR elimination, Golub/Van Loan): the plain sweep of the band
    kernels (``band_qr.band_solve_qr_multi``) on one chain and one
    right-hand side.  Unlike the unpivoted block-LU sweep, orthogonal
    elimination has bounded growth.  rhs and result (S, b)."""
    return band_solve_qr_multi(D[None], U[None], Lo[None],
                               rhs[None, :, :, None])[0, :, :, 0]


def band_solve(lu_all, U, Lo, rhs):
    """Solve with the factors of :func:`band_factor`; rhs/result (S, b)."""
    LU, piv = lu_all

    def lu_solve(k, r):
        return torch.linalg.lu_solve(LU[k], piv[k], r[:, None])[:, 0]

    S = rhs.shape[0]
    ys = [rhs[0]]
    for k in range(1, S):
        ys.append(rhs[k] - Lo[k - 1] @ lu_solve(k - 1, ys[-1]))
    xs = [lu_solve(S - 1, ys[-1])]
    for k in range(S - 2, -1, -1):
        xs.append(lu_solve(k, ys[k] - U[k] @ xs[-1]))
    return torch.stack(xs[::-1])
