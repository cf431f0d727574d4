"""Parametric NLP sensitivities (reference: do_mpc/differentiator/)."""
from ._nlpdifferentiator import NLPDifferentiator, DoMPCDifferentiator
from .helper import NLPDifferentiatorSettings, NLPDifferentiatorStatus

__all__ = ["NLPDifferentiator", "DoMPCDifferentiator",
           "NLPDifferentiatorSettings", "NLPDifferentiatorStatus"]
