"""Sampling / batch-study tooling (reference: do_mpc/sampling/)."""
from ._samplingplanner import SamplingPlanner
from ._sampler import Sampler
from ._datahandler import DataHandler

__all__ = ["SamplingPlanner", "Sampler", "DataHandler"]
