"""Controllers (PyTorch port): the nonlinear MPC, the LQR and their
settings."""
from ._mpc import MPC
from ._controllersettings import MPCSettings, ControllerSettings, LQRSettings
from ._lqr import LQR

__all__ = ["MPC", "LQR", "MPCSettings", "ControllerSettings", "LQRSettings"]
