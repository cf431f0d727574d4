"""Mixin providing x0/u0/z0/t0 numeric properties with shape validation
(reference: do_mpc/model/_iteratedvariables.py:28-212)."""
from __future__ import annotations

import numpy as np

from ..tools import NumStruct


class IteratedVariables:
    """Gives iterating classes (MPC, MHE, EKF, Simulator, ...) numeric
    ``x0``, ``u0``, ``z0`` structures and scalar time ``t0``."""

    def _init_iterated_variables(self, model):
        self.model = model
        self._x0 = NumStruct(model.spec("_x"))
        self._u0 = NumStruct(model.spec("_u"))
        self._z0 = NumStruct(model.spec("_z"))
        self._t0 = np.zeros(1)

    def _convert2struct(self, value, struct: NumStruct):
        if isinstance(value, NumStruct):
            struct.data[:] = value.data
            return struct
        arr = np.asarray(value, dtype=float).reshape(-1)
        assert arr.size == struct.spec.size, (
            f"Cannot assign value of size {arr.size} to structure of size "
            f"{struct.spec.size}.")
        struct.data[:] = arr
        return struct

    @property
    def x0(self) -> NumStruct:
        return self._x0

    @x0.setter
    def x0(self, value):
        self._convert2struct(value, self._x0)

    @property
    def u0(self) -> NumStruct:
        return self._u0

    @u0.setter
    def u0(self, value):
        self._convert2struct(value, self._u0)

    @property
    def z0(self) -> NumStruct:
        return self._z0

    @z0.setter
    def z0(self, value):
        self._convert2struct(value, self._z0)

    @property
    def t0(self):
        return self._t0

    @t0.setter
    def t0(self, value):
        self._t0 = np.atleast_1d(np.asarray(value, dtype=float)).reshape(1)
