"""Estimators (PyTorch port of the JAX package's ``estimator``): the state
feedback and the extended Kalman filter.  MHE is not ported yet."""
from ._base import Estimator, StateFeedback
from ._ekf import EKF
from ._estimatorsettings import EstimatorSettings, MHESettings

__all__ = ["Estimator", "StateFeedback", "EKF", "EstimatorSettings",
           "MHESettings"]
