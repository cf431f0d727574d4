"""Structure / utility tools (numpy-only copies of the JAX package's
``tools``: :class:`StructSpec`, :class:`NumStruct`, :class:`FieldAccessor`,
:class:`Timer`) plus the torch profiler hook."""
from ._structure import StructSpec, NumStruct, FieldAccessor, Structure
from ._timer import Timer
from . import _profiler as profiler

__all__ = ["StructSpec", "NumStruct", "FieldAccessor", "Structure", "Timer",
           "profiler"]
