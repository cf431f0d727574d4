"""Taylor linearization of a nonlinear Model into a LinearModel
(reference: do_mpc/model/_linearize.py:28-102); PyTorch port of the JAX
package's ``model/_linearize.py``."""
from __future__ import annotations

import numpy as np

from ._linearmodel import LinearModel


def linearize(model, xss=None, uss=None, tvp0=None, p0=None) -> LinearModel:
    assert model.flags["setup"], "Model must be setup."
    assert model.n_z == 0, "Linearization is not supported for DAE systems."
    A, B, C, D = model.get_linear_system_matrices(
        xss=xss, uss=uss, tvpss=tvp0, pss=p0)
    # trivial measurement detection (reference :94-97)
    trivial_C = (model.n_y == model.n_x and np.allclose(C, np.eye(model.n_x))
                 and np.allclose(D, 0))
    lm = LinearModel(model.model_type)
    for name in model.spec("_x").names:
        lm.set_variable("_x", name, model.spec("_x").shapes[name])
    for name in model.spec("_u").names:
        lm.set_variable("_u", name, model.spec("_u").shapes[name])
    if model.n_y and not trivial_C:
        lm.setup(A, B, C, D)
    else:
        lm.setup(A, B)
    return lm
