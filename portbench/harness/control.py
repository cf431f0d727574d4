"""The control of the comparison: the program's answers carried in the
next precision below the configuration's float32, TF32 (10 mantissa bits,
as the tensor cores take float32 operands), put in the program's place.
A comparison that cannot tell these answers from the program's would pass
a later change that computed in TF32.

``rounded_answers(program)`` wraps the program's ``solve`` so that every
field of the solution and u0 are rounded to TF32, to nearest."""
from __future__ import annotations

import torch


def tf32_round(t):
    """``t`` rounded to TF32's 10-bit mantissa (float32 tensors only)."""
    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rounded_answers(program):
    solve = program.solve

    def wrapped(*args, **kw):
        sol, u0 = solve(*args, **kw)
        sol = sol._replace(**{f: tf32_round(getattr(sol, f))
                              for f in ("w", "s", "lam", "zl", "zu")})
        return sol, tf32_round(u0)
    wrapped.ipm = solve.ipm
    program.solve = wrapped
