"""The control of the comparison for a float64 configuration: the
program's answers carried in float32, the next precision below, put in the
program's place.  A comparison that cannot tell these answers from the
program's would pass a later change that computed the solve in float32.

``rounded_answers(program)`` wraps the program's ``solve`` so that every
field of the solution and u0 are rounded to float32, to nearest, and
handed back in their own dtype."""
from __future__ import annotations

import torch


def f32_round(t):
    """``t`` rounded to float32 (float64 tensors only), kept float64."""
    if t.dtype != torch.float64:
        return t
    return t.to(torch.float32).to(torch.float64)


def rounded_answers(program):
    solve = program.solve

    def wrapped(*args, **kw):
        sol, u0 = solve(*args, **kw)
        sol = sol._replace(**{f: f32_round(getattr(sol, f))
                              for f in ("w", "s", "lam", "zl", "zu")})
        return sol, f32_round(u0)
    wrapped.ipm = solve.ipm
    program.solve = wrapped
