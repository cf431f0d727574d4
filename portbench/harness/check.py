"""The comparison that decides ``correct``.

Once the window has closed, the reference judges the answers of the
calls drawn from the seed (every instance of each), in float64 and in
blocks of rows:

* ``kkt_err_max``: the largest KKT error (:mod:`portbench.reference.kkt`)
  of an instance the program counted as certified;
* ``feas_max``: the largest violation of the point's bounds and signs
  (``lb <= w <= ub`` relative to the bound's size, ``s >= 0``, the bound
  duals ``>= 0``; :func:`~portbench.reference.kkt.bound_violation`) of an
  instance the program counted as certified;
* ``u0_gap_max``: the largest gap between the u0 the program handed back
  and the first input of its own solution, relative to the input's size
  plus its scaling;
* ``uncertified_share``: of every instance of the window, the share the
  program did not certify, returned non-finite or out of the input
  bounds (counted by the harness on the host after each call).

Each number has its own limit in ``portbench/limits/<cell>.json``; a
number that is not finite fails.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.kkt import bound_violation, kkt_error

BLOCK = 256


def judge(tr, retained, s_max):
    """{name: value} of the compared numbers over ``retained`` calls (each
    a dict of x0s, u0, ok, and the solution's w, s, lam, zl, zu)."""
    kkt_max = feas_max = gap_max = 0.0
    us = torch.as_tensor(tr.us, dtype=torch.float64)
    for call in retained:
        idx = np.nonzero(call["ok"])[0]
        dev = call["w"].device
        us_d = us.to(dev)
        for i in range(0, idx.size, BLOCK):
            rows = torch.as_tensor(idx[i:i + BLOCK], device=dev)
            x0 = torch.as_tensor(call["x0s"][idx[i:i + BLOCK]],
                                 dtype=torch.float64, device=dev)
            w, s, lam, zl, zu = (call[k][rows] for k in
                                 ("w", "s", "lam", "zl", "zu"))
            err = kkt_error(tr, x0, w, s, lam, zl, zu, s_max=s_max)[0]
            kkt_max = max(kkt_max, _worst(err))
            feas_max = max(feas_max,
                           _worst(bound_violation(tr, w, s, zl, zu)))
            u0_ref = call["w"][rows][:, tr.u0_idx].to(torch.float64) * us_d
            u0 = torch.as_tensor(call["u0"][idx[i:i + BLOCK]],
                                 dtype=torch.float64, device=dev)
            gap = (u0 - u0_ref).abs() / (u0_ref.abs() + us_d)
            gap_max = max(gap_max, _worst(gap))
    return {"kkt_err_max": kkt_max, "feas_max": feas_max,
            "u0_gap_max": gap_max}


def _worst(t):
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(t.max()) if t.numel() else 0.0


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number finite and within
    its limit."""
    rows = [(k, numbers[k], float(limits[k])) for k in numbers]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
