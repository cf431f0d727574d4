"""Controllers (PyTorch port): the nonlinear MPC and its settings."""
from ._mpc import MPC
from ._controllersettings import MPCSettings, ControllerSettings, LQRSettings

__all__ = ["MPC", "MPCSettings", "ControllerSettings", "LQRSettings"]
