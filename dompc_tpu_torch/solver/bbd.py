"""Bordered-block-diagonal (arrowhead) KKT factorization (PyTorch port).

The scenario-tree OCP KKT system is, after the robust horizon, a set of
independent leaf-scenario stage chains coupled only through shared
tree-ancestor variables:

    K = [ A   B ]     A = blkdiag over chains of block-tridiagonal bands
        [ B^T R ]     B = border (chain rows x root cols), R = small root

Solve by Schur complement on the root:

    1. one multi-RHS block-QR sweep over all chains of the batch:
       Y_c = A_c^{-1} [B_c, rhs_c]          (solver/band_qr.py: a CUDA
                                            kernel on the card, the plain
                                            sweep on the CPU)
    2. S = R - sum_c B_c^T Y_c[:, :r];  x_r = S^{-1} (rhs_r - sum B^T y)
    3. x_c = y_c - Y_c[:, :r] x_r

Chain/root assignment is computed from usage (``demote_by_usage``).
Assembly maps are built in numpy once; the index arrays live on the
solver's device as tensors.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from . import band_qr, batchqr
from ..tools import _profiler as profiler
from .band_qr import band_solve_qr_multi  # noqa: F401  (JAX's bbd name)

ROOT = -1       # chain id of root-assigned entities
PARAM = -2      # chain id of parameter/dummy columns (dropped)


def scatter_sum_cols(idx, src, n):
    """(B, n) whose column ``idx[j]`` sums ``src[:, j]`` over every j with
    that index.  ``index_put_`` with accumulate sorts the indices and sums
    repeated ones in one fixed order; ``index_add`` on CUDA sums them with
    atomics in an order that varies from run to run, and with it the
    solver's rounding (two runs could take different iteration counts)."""
    out = src.new_zeros((n, src.shape[0]))
    out.index_put_((idx,), src.T, accumulate=True)
    return out.T


def _gather_plan(targets, srcs, garbage, t_size, k_low=4):
    """Invert a scatter-add into a two-tier gather plan.

    ``targets[i] = t`` means source position ``srcs[i]`` contributes to
    flat slot ``t``.  ``low`` covers all slots at width ``k_low``; the few
    slots with more contributions get their own narrow-tall matrix plus a
    unique-index add of their sums.  The garbage slot (``t_size - 1``) is
    excluded and must be written as 0.  Apply with :func:`_gather_apply`."""
    targets = np.asarray(targets).reshape(-1)
    srcs = np.asarray(srcs).reshape(-1)
    pad = int(srcs.max(initial=-1)) + 1
    keep = targets != garbage
    tk, sk = targets[keep], srcs[keep]
    order = np.argsort(tk, kind="stable")
    tk, sk = tk[order], sk[order]
    counts = np.bincount(tk, minlength=t_size - 1)
    K = max(int(counts.max(initial=0)), 1)
    k_low = min(k_low, K)
    first = np.zeros(t_size - 1, np.int64)
    first[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(tk)) - first[tk]

    high_slots = np.nonzero(counts > k_low)[0]
    is_high = np.zeros(t_size - 1, bool)
    is_high[high_slots] = True
    high_row = np.cumsum(is_high) - 1        # slot -> row in high_mat

    low_mat = np.full((t_size - 1, k_low), pad, dtype=np.int64)
    sel = ~is_high[tk]
    low_mat[tk[sel], rank[sel]] = sk[sel]
    high_mat = np.full((len(high_slots), K), pad, dtype=np.int64)
    sel = is_high[tk]
    high_mat[high_row[tk[sel]], rank[sel]] = sk[sel]
    return {"low": low_mat, "high_slots": high_slots.astype(np.int64),
            "high": high_mat, "pad": pad}


def _plan_to(plan, device):
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in plan.items()}


def _gather_apply(plan, V):
    """Evaluate a _gather_plan (index tensors on V's device).  ``V``:
    (B, sources) WITH a trailing zero at the pad position.  Returns T of
    shape (B, t_size - 1)."""
    T = V[:, plan["low"]].sum(dim=-1)
    if plan["high_slots"].numel():
        hs = V[:, plan["high"]].sum(dim=-1)
        T = T.index_add(1, plan["high_slots"], hs)
    return T


def demote_by_usage(var_chain, var_stage, A_all, n, inst_chain, inst_stage):
    """Demote variables to the root wherever the proposed chain assignment
    cannot be represented in the (band, border, root) structure.

    A variable stays on a chain only if every *chain* instance referencing
    it belongs to that same chain, the referencing stages span at most one
    block, and the variable's own stage is adjacent to all of them.
    """
    var_chain = np.asarray(var_chain, int).copy()
    var_stage = np.asarray(var_stage, int).copy()
    I, d = A_all.shape
    cols = A_all.reshape(-1)
    ich = np.repeat(np.asarray(inst_chain, int), d)
    ist = np.repeat(np.asarray(inst_stage, int), d)
    ok = (cols < n) & (ich != ROOT)
    cols, ich, ist = cols[ok], ich[ok], ist[ok]

    cmin = np.full(n, np.iinfo(np.int64).max)
    cmax = np.full(n, np.iinfo(np.int64).min)
    smin = np.full(n, np.iinfo(np.int64).max)
    smax = np.full(n, np.iinfo(np.int64).min)
    np.minimum.at(cmin, cols, ich)
    np.maximum.at(cmax, cols, ich)
    np.minimum.at(smin, cols, ist)
    np.maximum.at(smax, cols, ist)

    used = cmax >= 0
    bad = used & (
        (cmin != cmax)                      # referenced by >1 chain
        | (var_chain >= 0) & (var_chain != cmax)  # not the owning chain
        | (smax - smin > 1)                 # stage span too wide
        | (var_stage < smax - 1)            # own stage not adjacent
        | (var_stage > smin + 1))
    var_chain[bad & (var_chain >= 0)] = ROOT
    return var_chain, var_stage


def _slot_sizes(entities, C, S):
    """Local slot of every (chain, stage) entity: rows ordered
    [w, lam_g, lam_h] per (chain, stage); root entities count up in the
    same order.  ``entities``: [(chain, stage, loc_out, skip)]."""
    sizes = np.zeros((C, S), int)
    root_count = 0
    for arr_chain, arr_stage, arr_loc, skip in entities:
        for c in range(C):
            for k in range(S):
                sel = np.nonzero((arr_chain == c) & (arr_stage == k)
                                 & ~skip)[0]
                arr_loc[sel] = sizes[c, k] + np.arange(len(sel))
                sizes[c, k] += len(sel)
        sel = np.nonzero((arr_chain == ROOT) & ~skip)[0]
        arr_loc[sel] = root_count + np.arange(len(sel))
        root_count += len(sel)
    return sizes, root_count


class _BandLayout:
    """Flat slot arithmetic shared by both assemblers: T = [D | U | Lo |
    border | root | garbage]."""

    def __init__(self, C, S, b, R):
        self.C, self.S, self.b, self.R = C, S, b, R
        self.band_sz = C * S * b * b
        self.bord_off = 3 * self.band_sz
        self.root_off = self.bord_off + C * S * b * R
        self.T_size = self.root_off + R * R + 1
        self.garbage = self.T_size - 1

    def pair_idx(self, r_ch, r_st, r_lc, c_ch, c_st, c_lc):
        """Map a (row, col) entry to its flat slot in T; root rows x chain
        columns are dropped (recovered by symmetry)."""
        S, b, R, bs = self.S, self.b, self.R, self.band_sz
        r_ch, r_st, r_lc, c_ch, c_st, c_lc = np.broadcast_arrays(
            r_ch, r_st, r_lc, c_ch, c_st, c_lc)
        out = np.full(r_ch.shape, self.garbage, dtype=np.int64)
        both = (r_ch >= 0) & (c_ch == r_ch)
        ds = c_st - r_st
        for band, sel, st in (
                (0, both & (ds == 0), r_st),
                (1, both & (ds == 1), r_st),
                (2, both & (ds == -1), np.maximum(r_st - 1, 0))):
            out[sel] = (band * bs + ((r_ch[sel] * S + st[sel]) * b
                                     + r_lc[sel]) * b + c_lc[sel])
        sel = (r_ch >= 0) & (c_ch == ROOT)
        out[sel] = (self.bord_off + ((r_ch[sel] * S + r_st[sel]) * b
                                     + r_lc[sel]) * R + c_lc[sel])
        sel = (r_ch == ROOT) & (c_ch == ROOT)
        out[sel] = self.root_off + r_lc[sel] * R + c_lc[sel]
        return out

    def pad_diag(self, sizes):
        pad = np.zeros((self.C, self.S, self.b))
        for c in range(self.C):
            for k in range(self.S):
                pad[c, k, sizes[c, k]:self.b - 1] = 1.0
        return pad

    def split(self, T, pad_diag):
        """(D, U, Lo, Bord, Root) of a batch from the flat assembled rows
        T (B, T_size); the trash slot b-1 of every block gets an identity
        row/column."""
        C, S, b, R, bs = self.C, self.S, self.b, self.R, self.band_sz
        B = T.shape[0]
        D = T[:, :bs].reshape(B, C, S, b, b)
        U = T[:, bs:2 * bs].reshape(B, C, S, b, b)
        Lo = T[:, 2 * bs:3 * bs].reshape(B, C, S, b, b)
        Bord = T[:, self.bord_off:self.root_off].reshape(B, C, S, b, R)
        Root = T[:, self.root_off:self.root_off + R * R].reshape(B, R, R)
        tr = b - 1
        for M in (D, U, Lo):
            M[..., tr, :] = 0.0
            M[..., :, tr] = 0.0
        D[..., tr, tr] = 1.0
        if R:
            Bord[..., tr, :] = 0.0
        D = D + torch.diag_embed(pad_diag)
        # U slot k: (stage k rows, stage k+1 cols); Lo slot k: (stage k+1
        # rows, stage k cols) -- slots 0..S-2
        return D, U[:, :, :-1], Lo[:, :, :-1], Bord, Root


class BBDAssembler:
    """Maps from instance-local derivative tensors into the (band, border,
    root) representation of the uncondensed KKT system.

    Every primal variable and constraint row has a chain id (``ROOT`` for
    root) and a chain-stage.  ``A_all`` maps each instance's local variables
    to global columns (columns >= n are parameters and are dropped);
    ``R_g``/``R_h`` map instance rows to global equality/inequality rows.
    """

    def __init__(self, var_chain, var_stage, g_chain, g_stage,
                 h_chain, h_stage, A_all, R_g, R_h, n, m, q,
                 init_cols=None, *, device):
        var_chain = np.asarray(var_chain, int)
        var_stage = np.asarray(var_stage, int)
        g_chain = np.asarray(g_chain, int)
        g_stage = np.asarray(g_stage, int)
        h_chain = np.asarray(h_chain, int)
        h_stage = np.asarray(h_stage, int)
        self.n, self.m, self.q = n, m, q
        I, d = A_all.shape
        E = R_g.shape[1]

        C = max(int(max(var_chain.max(initial=-1), g_chain.max(initial=-1),
                        h_chain.max(initial=-1))) + 1, 1)
        S = 1 + int(max(
            var_stage[var_chain >= 0].max(initial=0),
            g_stage[g_chain >= 0].max(initial=0),
            h_stage[h_chain >= 0].max(initial=0)))
        self.C, self.S = C, S

        w_loc = np.zeros(n, int)
        g_loc = np.zeros(m, int)
        h_loc = np.zeros(q, int)
        sizes, R = _slot_sizes(
            [(var_chain, var_stage, w_loc, np.zeros(n, bool)),
             (g_chain, g_stage, g_loc, np.zeros(m, bool)),
             (h_chain, h_stage, h_loc, np.zeros(q, bool))], C, S)
        self.R = R
        b = int(sizes.max()) + 1          # last slot = trash
        self.b = b
        lay = _BandLayout(C, S, b, R)
        self._lay = lay
        pair_idx = lay.pair_idx

        zcol = np.minimum(A_all, n - 1)
        col_ch = np.where(A_all < n, var_chain[zcol], PARAM)
        col_st = np.where(A_all < n, var_stage[zcol], 0)
        col_lc = np.where(A_all < n, w_loc[zcol], 0)
        col = (col_ch[:, None, :], col_st[:, None, :], col_lc[:, None, :])

        h_idx = pair_idx(col_ch[:, :, None], col_st[:, :, None],
                         col_lc[:, :, None], *col)
        g_row = (g_chain[R_g][:, :, None], g_stage[R_g][:, :, None],
                 g_loc[R_g][:, :, None])
        jg_idx = pair_idx(*g_row, *col)
        jg_idx_T = pair_idx(*col, *g_row)
        if q:
            h_row = (h_chain[R_h][:, :, None], h_stage[R_h][:, :, None],
                     h_loc[R_h][:, :, None])
            jh_idx = pair_idx(*h_row, *col)
            jh_idx_T = pair_idx(*col, *h_row)
        w_diag_idx = pair_idx(var_chain, var_stage, w_loc,
                              var_chain, var_stage, w_loc)
        g_diag_idx = pair_idx(g_chain, g_stage, g_loc,
                              g_chain, g_stage, g_loc)
        h_diag_idx = pair_idx(h_chain, h_stage, h_loc,
                              h_chain, h_stage, h_loc)
        if init_cols is not None and len(init_cols):
            nx0 = len(init_cols)
            ic = np.asarray(init_cols, int)
            init_idx = np.concatenate([
                pair_idx(g_chain[:nx0], g_stage[:nx0], g_loc[:nx0],
                         var_chain[ic], var_stage[ic], w_loc[ic]),
                pair_idx(var_chain[ic], var_stage[ic], w_loc[ic],
                         g_chain[:nx0], g_stage[:nx0], g_loc[:nx0])])
        else:
            init_idx = np.zeros((0,), np.int64)

        def pos(ch, st, lc):
            return np.where(ch >= 0, (ch * S + st) * b + lc, C * S * b + lc)

        w_pos = pos(var_chain, var_stage, w_loc)
        self.vec_size = C * S * b + R
        mask = np.zeros(self.vec_size)
        mask[w_pos] = 1.0
        self.w_mask_chain = mask[:C * S * b].reshape(C, S, b)
        self.w_mask_root = mask[C * S * b:]

        # gather-form assembly: sources are [H_i | Jg_i (both
        # orientations) | Jh_i (both) | ones(init) | sig_w_delta | g_diag
        # | h_diag | 0-pad]
        nH, nJg = I * d * d, I * E * d
        nJh = I * R_h.shape[1] * d if q else 0
        sJg = np.arange(nJg) + nH
        sJh = np.arange(nJh) + nH + nJg
        off = nH + nJg + nJh
        targets = [h_idx, jg_idx, jg_idx_T]
        srcs = [np.arange(nH), sJg, sJg]
        if q:
            targets += [jh_idx, jh_idx_T]
            srcs += [sJh, sJh]
        targets += [init_idx]
        srcs += [np.arange(len(init_idx)) + off]
        off += len(init_idx)
        targets += [w_diag_idx, g_diag_idx]
        srcs += [np.arange(n) + off, np.arange(m) + off + n]
        off += n + m
        if q:
            targets += [h_diag_idx]
            srcs += [np.arange(q) + off]
        plan = _gather_plan(
            np.concatenate([np.asarray(t).reshape(-1) for t in targets]),
            np.concatenate(srcs), lay.garbage, lay.T_size)
        self._n_init_ones = len(init_idx)

        dev = torch.device(device)
        self._gather = _plan_to(plan, dev)
        self._pad_diag = torch.as_tensor(lay.pad_diag(sizes), device=dev)
        self.w_pos = torch.as_tensor(w_pos, device=dev)
        self.g_pos = torch.as_tensor(pos(g_chain, g_stage, g_loc), device=dev)
        self.h_pos = torch.as_tensor(pos(h_chain, h_stage, h_loc), device=dev)

    def assemble(self, H_i, Jg_i, Jh_i, sig_w_delta, g_diag, h_diag):
        """Build (D, U, Lo, Bord, Root) of a batch from instance tensors
        (B, I, ...) and diagonals (B, ...) by gather+sum."""
        B = H_i.shape[0]
        V = torch.cat([
            H_i.reshape(B, -1), Jg_i.reshape(B, -1), Jh_i.reshape(B, -1),
            H_i.new_ones((B, self._n_init_ones)), sig_w_delta, g_diag]
            + ([h_diag] if self.q else []) + [H_i.new_zeros((B, 1))], dim=1)
        T = _gather_apply(self._gather, V)
        T = torch.cat([T, T.new_zeros((B, 1))], dim=1)
        return self._lay.split(T, self._pad_diag.to(H_i.dtype))

    def pack_rhs(self, r_w, r_g, r_h):
        vec = r_w.new_zeros((r_w.shape[0], self.vec_size))
        vec[:, self.w_pos] = r_w
        vec[:, self.g_pos] = r_g
        if self.q:
            vec[:, self.h_pos] = r_h
        csb = self.C * self.S * self.b
        return (vec[:, :csb].reshape(-1, self.C, self.S, self.b),
                vec[:, csb:])

    def unpack_sol(self, x_c, x_r):
        B = x_c.shape[0]
        flat = torch.cat([x_c.reshape(B, -1), x_r], dim=1)
        dh = flat[:, self.h_pos] if self.q else x_c.new_zeros((B, 0))
        return flat[:, self.w_pos], flat[:, self.g_pos], dh


class CondensedAssembler:
    """Entity-pair assembly for the *condensed* BBD system.

    The per-instance collocation interior (collocation states/algebraic
    variables and their residual rows, referenced by no other instance) is
    Schur-eliminated by batched dense solves BEFORE band assembly, so the
    band block size drops from O(n_coll*n_x + ...) to O(n_x + n_u).  The
    condensed per-instance block ``C_i`` is a full symmetric matrix over
    boundary entities (boundary variables, boundary equality rows,
    inequality rows); this assembler maps each entity to a (chain, stage,
    slot) and gathers the whole (n_ent, n_ent) block.

    Parameters mirror BBDAssembler, plus:
      B_cols   (I, n_bv) global column ids of boundary vars (>= n dropped)
      B_grows  (I, n_br) global eq-row ids of boundary rows
      skip_var (n,) bool: interior vars (get no slot)
      skip_g   (m,) bool: interior eq rows (get no slot)
    """

    def __init__(self, var_chain, var_stage, g_chain, g_stage,
                 h_chain, h_stage, B_cols, B_grows, R_h, n, m, q,
                 init_cols, skip_var, skip_g, *, device):
        var_chain = np.asarray(var_chain, int)
        var_stage = np.asarray(var_stage, int)
        g_chain = np.asarray(g_chain, int)
        g_stage = np.asarray(g_stage, int)
        h_chain = np.asarray(h_chain, int)
        h_stage = np.asarray(h_stage, int)
        skip_var = np.asarray(skip_var, bool)
        skip_g = np.asarray(skip_g, bool)
        self.n, self.m, self.q = n, m, q
        nlr = R_h.shape[1]

        C = max(int(max(var_chain[~skip_var].max(initial=-1),
                        g_chain[~skip_g].max(initial=-1),
                        h_chain.max(initial=-1))) + 1, 1)
        live_v = (~skip_var) & (var_chain >= 0)
        live_g = (~skip_g) & (g_chain >= 0)
        S = 1 + int(max(var_stage[live_v].max(initial=0),
                        g_stage[live_g].max(initial=0),
                        h_stage[h_chain >= 0].max(initial=0)))
        self.C, self.S = C, S

        w_loc = np.zeros(n, int)
        g_loc = np.zeros(m, int)
        h_loc = np.zeros(q, int)
        sizes, R = _slot_sizes(
            [(var_chain, var_stage, w_loc, skip_var),
             (g_chain, g_stage, g_loc, skip_g),
             (h_chain, h_stage, h_loc, np.zeros(q, bool))], C, S)
        self.R = R
        b = int(sizes.max()) + 1
        self.b = b
        lay = _BandLayout(C, S, b, R)
        self._lay = lay
        pair_idx = lay.pair_idx

        # ---- per-entity (chain, stage, loc) triples ---------------------
        zcol = np.minimum(B_cols, n - 1)
        vc = np.where((B_cols < n) & ~skip_var[zcol], var_chain[zcol], PARAM)
        vs = np.where(B_cols < n, var_stage[zcol], 0)
        vl = np.where(B_cols < n, w_loc[zcol], 0)
        parts_ch = [vc, g_chain[B_grows]]
        parts_st = [vs, g_stage[B_grows]]
        parts_lc = [vl, g_loc[B_grows]]
        if nlr:
            parts_ch.append(h_chain[R_h])
            parts_st.append(h_stage[R_h])
            parts_lc.append(h_loc[R_h])
        ent_ch = np.concatenate(parts_ch, axis=1)
        ent_st = np.concatenate(parts_st, axis=1)
        ent_lc = np.concatenate(parts_lc, axis=1)
        self.n_ent = ent_ch.shape[1]
        ent_pair_idx = pair_idx(
            ent_ch[:, :, None], ent_st[:, :, None], ent_lc[:, :, None],
            ent_ch[:, None, :], ent_st[:, None, :], ent_lc[:, None, :])

        # global diagonals (sig_w + delta on live vars; skipped vars ->
        # garbage so the caller can pass full-length vectors)
        vch_all = np.where(skip_var, PARAM, var_chain)
        w_diag_idx = pair_idx(vch_all, var_stage, w_loc,
                              vch_all, var_stage, w_loc)
        if init_cols is not None and len(init_cols):
            nx0 = len(init_cols)
            ic = np.asarray(init_cols, int)
            init_idx = np.concatenate([
                pair_idx(g_chain[:nx0], g_stage[:nx0], g_loc[:nx0],
                         var_chain[ic], var_stage[ic], w_loc[ic]),
                pair_idx(var_chain[ic], var_stage[ic], w_loc[ic],
                         g_chain[:nx0], g_stage[:nx0], g_loc[:nx0])])
            # the init rows belong to no instance: their own -delta_cons
            # diagonal is assembled separately
            g_diag_init_idx = pair_idx(
                g_chain[:nx0], g_stage[:nx0], g_loc[:nx0],
                g_chain[:nx0], g_stage[:nx0], g_loc[:nx0])
        else:
            init_idx = np.zeros((0,), np.int64)
            g_diag_init_idx = np.zeros((0,), np.int64)

        # rhs scatter / solution gather (flat = [chain, root, trash])
        def pos(ch, st, lc, skip):
            out = np.where(ch >= 0, (ch * S + st) * b + lc, C * S * b + lc)
            return np.where(skip | (ch == PARAM), C * S * b + R, out)

        w_pos = pos(var_chain, var_stage, w_loc, skip_var)
        self.vec_size = C * S * b + R + 1   # + trash
        mask = np.zeros(self.vec_size)
        mask[w_pos[~skip_var]] = 1.0
        mask[-1] = 0.0
        self.w_mask_chain = mask[:C * S * b].reshape(C, S, b)
        self.w_mask_root = mask[C * S * b:C * S * b + R]

        # gather-form assembly: sources [C_i | sig_w_delta | ones(init) |
        # g_diag_init | 0-pad]
        targets = np.concatenate([ent_pair_idx.reshape(-1), w_diag_idx,
                                  init_idx, g_diag_init_idx])
        self._n_init_ones = len(init_idx)
        plan = _gather_plan(targets, np.arange(targets.shape[0]),
                            lay.garbage, lay.T_size)

        dev = torch.device(device)
        self._gather = _plan_to(plan, dev)
        self._pad_diag = torch.as_tensor(lay.pad_diag(sizes), device=dev)
        self.w_pos = torch.as_tensor(w_pos, device=dev)
        self.g_pos = torch.as_tensor(pos(g_chain, g_stage, g_loc, skip_g),
                                     device=dev)
        self.h_pos = torch.as_tensor(
            pos(h_chain, h_stage, h_loc, np.zeros(q, bool)), device=dev)
        self.ent_pos = torch.as_tensor(
            pos(ent_ch, ent_st, ent_lc, ent_ch == PARAM).reshape(-1),
            device=dev)

    def assemble(self, C_i, sig_w_delta, g_diag_init):
        """Assemble condensed per-instance blocks of a batch into (D, U,
        Lo, Bord, Root) by two-tier gather+sum.  ``C_i``: (B, I, n_ent,
        n_ent) symmetric condensed blocks; ``sig_w_delta``: (B, n) diagonal
        for live vars; ``g_diag_init``: (B, n_x0) diagonal of the
        initial-condition rows."""
        B = C_i.shape[0]
        V = torch.cat([
            C_i.reshape(B, -1), sig_w_delta,
            C_i.new_ones((B, self._n_init_ones)),
            g_diag_init.reshape(B, -1), C_i.new_zeros((B, 1))], dim=1)
        T = _gather_apply(self._gather, V)
        T = torch.cat([T, T.new_zeros((B, 1))], dim=1)
        return self._lay.split(T, self._pad_diag.to(C_i.dtype))

    def pack_rhs(self, b_w, b_g, b_h):
        vec = b_w.new_zeros((b_w.shape[0], self.vec_size))
        vec[:, self.w_pos] = b_w
        vec[:, self.g_pos] = b_g
        if self.q:
            vec[:, self.h_pos] = b_h
        vec[:, -1] = 0.0
        csb = self.C * self.S * self.b
        return (vec[:, :csb].reshape(-1, self.C, self.S, self.b),
                vec[:, csb:csb + self.R])

    def add_corrections(self, rhs_c, rhs_r, corr):
        """Subtract per-instance boundary corrections (Schur rhs term
        M_bi M_ii^{-1} b_int); corr: (B, I, n_ent)."""
        B = corr.shape[0]
        csb = self.C * self.S * self.b
        vec = scatter_sum_cols(self.ent_pos, corr.reshape(B, -1),
                               self.vec_size)
        return (rhs_c - vec[:, :csb].reshape(B, self.C, self.S, self.b),
                rhs_r - vec[:, csb:csb + self.R])

    def unpack_sol(self, x_c, x_r):
        B = x_c.shape[0]
        flat = torch.cat([x_c.reshape(B, -1), x_r, x_c.new_zeros((B, 1))],
                         dim=1)
        dh = flat[:, self.h_pos] if self.q else x_c.new_zeros((B, 0))
        return (flat[:, self.w_pos], flat[:, self.g_pos], dh,
                flat[:, self.ent_pos].reshape(B, -1, self.n_ent))


def bbd_kkt_solve(assembler, dtype, backend, n_refine):
    """``solve(ctx, r_dw, r_g, r_h_mod, delta) -> (dw, dlam_g, dlam_h)`` of
    an uncondensed structured KKT backend: ``ctx`` is ``assembler.assemble``'s
    (D, U, Lo, Bord, Root) of a batch; the primal regularization ``delta``
    (B,) goes on the variables' diagonal slots.  Each band solve takes
    ``n_refine`` refinement passes (``Optimizer._make_solver`` decides them:
    none in float32)."""
    device = assembler.w_pos.device
    mask_c = torch.as_tensor(assembler.w_mask_chain, dtype=dtype,
                             device=device)
    mask_r = torch.as_tensor(assembler.w_mask_root, dtype=dtype,
                             device=device)

    def solve(ctx, r_dw, r_g, r_h_mod, delta):
        D, U, Lo, Bord, Root = ctx
        D = D + torch.diag_embed(delta[:, None, None, None] * mask_c)
        if assembler.R:
            Root = Root + torch.diag_embed(delta[:, None] * mask_r)
        rhs_c, rhs_r = assembler.pack_rhs(-r_dw, -r_g, -r_h_mod)
        x_c, x_r = bbd_solve(D, U, Lo, Bord, Root, rhs_c, rhs_r,
                             n_refine=n_refine, backend=backend)
        return assembler.unpack_sol(x_c, x_r)
    return solve


def band_matvec(D, U, Lo, X):
    """Apply the block-tridiagonal operators; X (N,S,b,t)."""
    Y = torch.einsum("nkij,nkjt->nkit", D, X)
    if D.shape[1] > 1:
        Y[:, :-1] += torch.einsum("nkij,nkjt->nkit", U, X[:, 1:])
        Y[:, 1:] += torch.einsum("nkij,nkjt->nkit", Lo, X[:, :-1])
    return Y


def bbd_matvec(D, U, Lo, Bord, Root, x_c, x_r):
    """Apply the full BBD operator; x_c (..., C,S,b), x_r (..., R), with
    any leading batch axes."""
    S, b = x_c.shape[-2:]
    N = x_c.numel() // (S * b)
    y = band_matvec(D.reshape(N, S, b, b), U.reshape(N, S - 1, b, b),
                    Lo.reshape(N, S - 1, b, b),
                    x_c.reshape(N, S, b, 1)).reshape(x_c.shape)
    if Root.shape[-1]:
        y = y + torch.einsum("...ckir,...r->...cki", Bord, x_r)
        y_r = torch.einsum("...rs,...s->...r", Root, x_r) \
            + torch.einsum("...ckir,...cki->...r", Bord, x_c)
    else:
        y_r = x_c.new_zeros(x_r.shape)
    return y, y_r


SPIKE_S_MIN = 48      # chains this long are partitioned (SPIKE) on the card,
                      # as in the JAX package (bbd.py:807-853)
BAND_BACKENDS = ("", "pallas", "pallas_tiled")   # values with a CUDA kernel


def band_backend(dtype, device):
    """The chain sweep that ``DOMPC_TPU_BAND_BACKEND`` selects, read once
    when a KKT backend is built (the JAX package reads it at trace time,
    ``bbd.py:776-794``): ``"pallas"`` (the default) sweeps with
    :func:`band_qr.band_solve`, ``"pallas_tiled"`` with
    :func:`band_qr.band_solve_tiled`, float32 only; in float64 it warns
    and takes ``"pallas"``, as JAX falls back from its float32-only
    kernels.  The XLA formulations (``lanes``, ``lanes_wy``, ``scan``) have
    no kernel in the port: on CUDA they raise, and on the CPU, where every
    choice runs the plain sweep, they are returned as they are."""
    env = os.environ.get("DOMPC_TPU_BAND_BACKEND", "")
    choice = env or "pallas"
    if torch.device(device).type == "cuda" and env not in BAND_BACKENDS:
        raise ValueError(
            f"DOMPC_TPU_BAND_BACKEND={env!r} has no CUDA kernel in the "
            f"port; accepted values: {BAND_BACKENDS}")
    if choice == "pallas_tiled" and dtype != torch.float32:
        warnings.warn(
            f"DOMPC_TPU_BAND_BACKEND={choice} requires float32 inputs "
            f"(got {dtype}); using the 'pallas' band-QR kernel.")
        choice = "pallas"
    return choice


def _spike_parts(S, dtype, backend, n_refine):
    """The JAX package's SPIKE partition heuristic (``bbd.py:820-853``):
    (partition count, n_refine).  In float32 a partition also raises
    ``n_refine`` to ``DOMPC_TPU_SPIKE_F32_REFINE``."""
    spike_env = os.environ.get("DOMPC_TPU_SPIKE", "")
    if spike_env:
        n_parts = int(spike_env)
    elif dtype == torch.float32:
        sp_ref = int(os.environ.get("DOMPC_TPU_SPIKE_F32_REFINE", "2"))
        n_parts = (max(2, round((S + 1) / 8))
                   if (sp_ref and S >= SPIKE_S_MIN) else 0)
        if n_parts:
            n_refine = max(n_refine, sp_ref)
    else:
        n_parts = max(2, round((S + 1) / 8)) if S >= SPIKE_S_MIN else 0
    if n_parts < 2 or S < 2 * n_parts - 1 or backend == "lanes_wy":
        n_parts = 0
    return n_parts, n_refine


def spike_shapes(b, t, S=48, dtype=torch.float64):
    """The two sweeps of a SPIKE solve of one chain of S stages, b wide with
    t right-hand sides, on the card (the partition of :func:`_spike_parts`,
    the layout of ``batchqr.band_solve_spike_impl``): segments
    (P, L, b, 2b + t) and the reduced system (1, P - 1, b, t)."""
    P, _ = _spike_parts(S, dtype, "pallas", 0)
    L = -(-(S - (P - 1)) // P)
    return (P, L, b, 2 * b + t), (1, P - 1, b, t)


def chain_sweep(b, device, backend, n_parts):
    """The chain sweep ``bbd_solve`` takes, decided from the shape before any
    launch: (sweep, plain_route).  On the card a band wider than the
    kernels' widest row bucket takes the plain sweep (``plain_route``), as
    JAX routes chains past its fit rule to the XLA lanes sweep
    (``bbd.py:795-805``); the tiled kernel comes before SPIKE
    (``bbd.py:868-873``); chains of ``n_parts`` segments take SPIKE.  On the
    CPU JAX's "scan" choice sweeps the whole chain, whatever the partition
    (``bbd.py:884-885``)."""
    on_card = torch.device(device).type != "cpu"
    if on_card and b > band_qr.ROW_BUCKETS[-1]:
        plain = band_qr.band_solve_qr_multi
        if n_parts:
            return (lambda *chains: batchqr.band_solve_spike_impl(
                *chains, n_parts, sweep=plain)), True
        return plain, True
    if backend == "pallas_tiled":
        return band_qr.band_solve_tiled, False
    if n_parts and on_card:
        return (lambda *chains: batchqr.band_solve_spike_impl(
            *chains, n_parts)), False
    return band_qr.band_solve, False


def bbd_solve(D, U, Lo, Bord, Root, rhs_c, rhs_r, n_refine=0,
              backend="pallas"):
    """Solve a batch of bordered-block-diagonal systems.

    D (B,C,S,b,b); U, Lo (B,C,S-1,b,b); Bord (B,C,S,b,R); Root (B,R,R);
    rhs_c (B,C,S,b); rhs_r (B,R).  Without the leading B axis one system is
    solved.  One multi-RHS band sweep over all B*C chains computes
    A_c^{-1}[B_c, r_c] (``backend`` from :func:`band_backend`: the CUDA
    kernel for CUDA tensors, the plain sweep for CPU tensors), as the JAX
    package's custom-vmap rule flattens the batch into the chain axis.
    On the card, chains of S >= ``SPIKE_S_MIN`` stages are cut into the
    partition of :func:`_spike_parts` and solved by
    :func:`batchqr.band_solve_spike_impl` (two kernel launches a solve);
    on the CPU they take the plain sweep whole, as JAX's does.  A band
    wider than the kernels' widest row bucket takes the plain sweep on the
    card too (:func:`chain_sweep`), counted in ``bbd_solve.plain_routes``.
    The roots are then eliminated by batched small dense Schur-complement
    solves.  ``n_refine`` passes of iterative refinement re-run the sweep
    on the residual, each in span ``kkt.refine`` and counted in
    ``bbd_solve.refine_passes`` (the KKT backends pass none in float32;
    a float32 SPIKE partition raises it, :func:`_spike_parts`).
    """
    if D.ndim == 4:
        x_c, x_r = bbd_solve(*(a[None] for a in (D, U, Lo, Bord, Root,
                                                 rhs_c, rhs_r)),
                             n_refine=n_refine, backend=backend)
        return x_c[0], x_r[0]
    B, C, S, b, R = Bord.shape
    n_parts, n_refine = _spike_parts(S, D.dtype, backend, n_refine)
    sweep, plain_route = chain_sweep(b, D.device, backend, n_parts)
    if plain_route:
        warnings.warn(
            f"band b={b} exceeds the band kernels' widest row bucket "
            f"{band_qr.ROW_BUCKETS[-1]}; using the plain sweep.")
        _bbd_solve.plain_routes += 1
    D, U, Lo = (a.reshape((B * C,) + a.shape[2:]).contiguous()
                for a in (D, U, Lo))

    def one_solve(rc, rr):
        aug = torch.cat([Bord, rc[..., None]], dim=-1) if R \
            else rc[..., None]
        Y = sweep(D, U, Lo, aug.reshape(B * C, S, b, R + 1).contiguous())
        Y = Y.reshape(B, C, S, b, R + 1)
        if not R:
            return Y[..., 0], rc.new_zeros((B, 0))
        BtY = torch.einsum("bckir,bckit->brt", Bord, Y)    # (B, R, R+1)
        S_r = Root - BtY[..., :R]
        s_rhs = rr - BtY[..., R]
        # solve_ex: a singular root gives non-finite values, which the IPM
        # rejects, as with jnp.linalg.solve (and no host sync on the card)
        x_r = torch.linalg.solve_ex(S_r, s_rhs[..., None])[0][..., 0]
        x_c = Y[..., R] - torch.einsum("bckit,bt->bcki", Y[..., :R], x_r)
        return x_c, x_r

    with profiler.span("kkt.bbd_solve"):
        x_c, x_r = one_solve(rhs_c, rhs_r)
        Db, Ub, Lb = (a.reshape((B, C) + a.shape[1:]) for a in (D, U, Lo))
        for _ in range(n_refine):
            _bbd_solve.refine_passes += 1
            with profiler.span("kkt.refine"):
                y_c, y_r = bbd_matvec(Db, Ub, Lb, Bord, Root, x_c, x_r)
                e_c, e_r = one_solve(rhs_c - y_c, rhs_r - y_r)
                x_c = x_c + e_c
                x_r = x_r + e_r
    return x_c, x_r


# solves routed past the kernels to the plain sweep, and refinement passes
# (counted through the alias, so a caller that rebinds the module's name
# still counts here)
_bbd_solve = bbd_solve
bbd_solve.plain_routes = 0
bbd_solve.refine_passes = 0
