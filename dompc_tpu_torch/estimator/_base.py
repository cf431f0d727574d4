"""Estimator base and StateFeedback
(reference: do_mpc/estimator/_base.py:28-72)."""
from __future__ import annotations

import numpy as np

from ..model._iteratedvariables import IteratedVariables
from ..data import Data


class Estimator(IteratedVariables):
    def __init__(self, model):
        assert model.flags["setup"], "Model must be setup before Estimator."
        self._init_iterated_variables(model)
        self.data = Data(model)
        self.flags = {"setup": True}


class StateFeedback(Estimator):
    """Identity estimator: assumes all states are measured
    (reference: _base.py:55-72)."""

    def make_step(self, y0) -> np.ndarray:
        # the reference returns the measurement without logging (_base.py:63)
        return np.asarray(y0, dtype=float).reshape(-1, 1)
