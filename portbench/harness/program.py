"""The system under test: ``dompc_tpu_torch``'s batched entry,
``parallel.make_batch_solver(...)``'s ``solve_batch``, built for one
configuration.  The port is imported here and nowhere else in the
harness."""
from __future__ import annotations

import importlib
import os


def _resolve(spec):
    module, name = spec.split(":")
    return getattr(importlib.import_module(module), name)


def select_device(cfg, cpu=False):
    """Set the port's environment switches for ``cfg`` before any MPC is
    built: float64 only where the configuration states it, and the card
    unless ``cpu`` (rehearsals and tests)."""
    if cfg["dtype"] == "float64":
        os.environ["DOMPC_TPU_X64"] = "1"
    else:
        os.environ.pop("DOMPC_TPU_X64", None)
    if cpu:
        os.environ["DOMPC_TPU_PLATFORM"] = "cpu"
    else:
        os.environ.pop("DOMPC_TPU_PLATFORM", None)


class Program:
    """The configured MPC and its batched solver.

    ``solve(x0s, w0s, lam, mu0, zl, zu)`` is ``solve_batch``;
    ``cold_guess(x0s)`` is ``initial_guess_from_x0``; ``newton_steps()``
    reads the solver's own counter."""

    def __init__(self, cfg, n_horizon=None):
        import torch
        import dompc_tpu_torch  # noqa: F401  (sets the TF32 switches)
        from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                              make_batch_solver)
        prog = cfg["program"]
        kw = dict(prog.get("kwargs", {}))
        if n_horizon is not None:
            kw["n_horizon"] = n_horizon
        mpc_fn = _resolve(prog["mpc"])
        self.mpc = (mpc_fn(_resolve(prog["model"])(), **kw)
                    if prog.get("model") else mpc_fn(**kw))
        # float32 stays float32: TF32 off, as the configurations state
        torch.backends.cuda.matmul.allow_tf32 = False
        self._make = make_batch_solver
        self._guess = initial_guess_from_x0
        self.settings = dict(cfg["solver"])
        self.solve = self.solver()

    def solver(self, **overrides):
        """A ``solve_batch`` of this MPC with the configuration's settings
        (``overrides`` win)."""
        kw = dict(self.settings)
        kw.update(overrides)
        return self._make(self.mpc, **kw)

    def cold_guess(self, x0s):
        return self._guess(self.mpc, x0s)

    def newton_steps(self):
        return self.solve.ipm.newton_steps
