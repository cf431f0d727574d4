"""Model layer (PyTorch port): declarative :class:`Model`, the iterated
x0/u0/z0 mixin, linear models, linearization and DAE-to-ODE conversion."""
from ._model import Model, SymView, VAR_TYPES
from ._iteratedvariables import IteratedVariables
from ._linearmodel import LinearModel
from ._linearize import linearize
from ._dae2ode import dae2odeconversion

__all__ = ["Model", "LinearModel", "linearize", "dae2odeconversion",
           "IteratedVariables", "SymView", "VAR_TYPES"]
