"""Batched and sharded NMPC solves (PyTorch port of the JAX package's
``parallel``): batch-first solves on one device, and the batch axis
sharded over the ranks of a ``torch.distributed`` process group, one
process per device."""
from .batch import (make_batch_solver, make_sharded_solver, batch_mesh,
                    initial_guess_from_x0, make_shift_fn, init_distributed)

__all__ = ["make_batch_solver", "make_sharded_solver", "batch_mesh",
           "initial_guess_from_x0", "make_shift_fn", "init_distributed"]
