"""Index-1 DAE -> ODE conversion (PyTorch port of the JAX package's
``model/_dae2ode.py``; reference: do_mpc/model/_dae2odeconversion.py:27-109).

New states are [x, u, z], the new input is q = du/dt, and
dz/dt = -(dg/dz)^-1 (dg/dx * f + dg/du * q)   (reference :96).
The Jacobians of g come from ``torch.func.jacfwd`` at evaluation time, so
the converted right-hand side nests inside the model's own transforms; no
symbolic inversion.
"""
from __future__ import annotations

import torch

from ._model import Model
from ..sym import Sym, META


def dae2odeconversion(model) -> Model:
    assert model.flags["setup"], "Model must be setup."
    assert model.n_z > 0, "Model has no algebraic states."
    n_x, n_u, n_z = model.n_x, model.n_u, model.n_z

    conv = Model(model.model_type)
    conv.set_variable("_x", "x_new", (n_x + n_u + n_z, 1))
    if n_u:
        conv.set_variable("_u", "q", (max(n_u, 1), 1))
    for name in model.spec("_p").names:
        conv.set_variable("_p", name, model.spec("_p").shapes[name])
    for name in model.spec("_tvp").names:
        conv.set_variable("_tvp", name, model.spec("_tvp").shapes[name])

    p_spec, tvp_spec = model.spec("_p"), model.spec("_tvp")

    def rhs_fn(env):
        dtype = env[META][0]
        xc = env["_x"]["x_new"]
        x, u, z = xc[:n_x], xc[n_x:n_x + n_u], xc[n_x + n_u:]
        qv = env["_u"]["q"][:n_u] if n_u else xc.new_zeros((0,))
        p = p_spec.pack(env["_p"], xp=torch) if p_spec.size \
            else xc.new_zeros((0,))
        tvp = tvp_spec.pack(env["_tvp"], xp=torch) if tvp_spec.size \
            else xc.new_zeros((0,))
        w = xc.new_zeros((model.n_w,))
        f = model._rhs_fun(x, u, z, tvp, p, w)

        def jac(fun, arg):
            # forward-mode Jacobians may come back in float64 for a float32
            # function: cast to the state's dtype
            return torch.func.jacfwd(fun)(arg).to(dtype)
        g_x = jac(lambda xx: model._alg_fun(xx, u, z, tvp, p, w), x)
        g_z = jac(lambda zz: model._alg_fun(x, u, zz, tvp, p, w), z)
        r = g_x @ f
        if n_u:
            r = r + jac(lambda uu: model._alg_fun(x, uu, z, tvp, p, w),
                        u) @ qv
        z_dot = -torch.linalg.solve_ex(g_z, r[:, None])[0][:, 0]
        return torch.cat([f, qv, z_dot])

    conv.set_rhs("x_new", Sym(rhs_fn))
    conv.setup()
    return conv
