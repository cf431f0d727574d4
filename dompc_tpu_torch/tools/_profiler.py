"""Profiler annotations for solves (``torch.profiler`` counterpart of the
JAX package's ``jax.profiler`` step annotations).  A ``record_function``
range costs next to nothing when no profiler is active, so it stays on the
hot path."""
import torch


def step_annotation(name, step_num):
    """Named range ``<name>/<step_num>`` on the profiler timeline."""
    return torch.profiler.record_function(f"{name}/{int(step_num)}")
