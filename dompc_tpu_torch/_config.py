"""Device and dtype selection from the environment.

Mirrors the JAX package's switches: ``DOMPC_TPU_PLATFORM`` picks the
platform and ``DOMPC_TPU_X64=1`` opts into float64.  Both are read when an
MPC is set up, so a process can build CPU and CUDA controllers side by side
by setting the variable in between.
"""
import os

import torch


def resolve_device() -> torch.device:
    """``cpu`` when ``DOMPC_TPU_PLATFORM=cpu``, else ``cuda`` (raises if
    CUDA is unavailable: the port never falls back to the CPU unasked)."""
    plat = os.environ.get("DOMPC_TPU_PLATFORM", "").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise RuntimeError(
            f"DOMPC_TPU_PLATFORM={plat!r}: the torch port runs on 'cpu' or "
            "'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; set DOMPC_TPU_PLATFORM=cpu to run the "
            "port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_dtype() -> torch.dtype:
    return torch.float64 if os.environ.get("DOMPC_TPU_X64") == "1" \
        else torch.float32
