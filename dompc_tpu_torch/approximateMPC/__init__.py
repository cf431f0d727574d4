"""Neural approximate MPC (reference: do_mpc/approximateMPC/)."""
from ._ampc import ApproxMPC, FeedforwardNN
from ._ampc_sampler import AMPCSampler
from ._trainer import Trainer
from ._ampcsettings import (ApproximateMPCSettings, TrainerSettings,
                            AMPCSamplerSettings)

__all__ = ["ApproxMPC", "FeedforwardNN", "AMPCSampler", "Trainer",
           "ApproximateMPCSettings", "TrainerSettings",
           "AMPCSamplerSettings"]
