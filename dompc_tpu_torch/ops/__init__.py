"""Numerical building blocks (collocation coefficients)."""
from .collocation import collocation_points, lagrange_matrices

__all__ = ["collocation_points", "lagrange_matrices"]
