"""Estimators (PyTorch port of the JAX package's ``estimator``): the state
feedback, the extended Kalman filter and the moving-horizon estimator."""
from ._base import Estimator, StateFeedback
from ._ekf import EKF
from ._mhe import MHE
from ._estimatorsettings import EstimatorSettings, MHESettings

__all__ = ["Estimator", "StateFeedback", "EKF", "MHE", "EstimatorSettings",
           "MHESettings"]
