"""System identification tools (port of the JAX package's ``sysid``;
reference: do_mpc/sysid/)."""
from ._onnxconversion import ONNXConversion, ONNXOperations

__all__ = ["ONNXConversion", "ONNXOperations"]
