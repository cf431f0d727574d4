"""Model layer (PyTorch port): declarative :class:`Model` and the iterated
x0/u0/z0 mixin."""
from ._model import Model, SymView, VAR_TYPES
from ._iteratedvariables import IteratedVariables

__all__ = ["Model", "SymView", "VAR_TYPES", "IteratedVariables"]
