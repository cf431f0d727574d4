"""Differentiator settings/status dataclasses
(reference: do_mpc/differentiator/helper.py:14-117)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NLPDifferentiatorSettings:
    lin_solver: str = "dense"        # dense LU on the active-set KKT
    check_LICQ: bool = False
    check_SC: bool = False
    track_residuals: bool = True
    check_rank: bool = False
    lstsq_fallback: bool = True
    active_set_tol: float = 1e-6


@dataclass
class NLPDifferentiatorStatus:
    LICQ: bool | None = None
    SC: bool | None = None
    residuals: float | None = None
    lse_solved: bool = False
    full_rank: bool | None = None
    sym_KKT_system: bool = True
    reduced_nlp: bool = False
