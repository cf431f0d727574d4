"""Batched NMPC solves (PyTorch port of the JAX package's ``parallel``)."""
from .batch import initial_guess_from_x0, make_batch_solver, make_shift_fn

__all__ = ["initial_guess_from_x0", "make_batch_solver", "make_shift_fn"]
