"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one, since a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` configures JAX).
"""
import numpy as np
import pytest
import torch

from dompc_tpu_torch.solver import band_qr
from dompc_tpu_torch.solver.bbd import band_matvec


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the band kernels are CUDA only")


def _case(N, S, b, t, seed, dtype):
    """Diagonally dominant chains (|diag| 3b against off-diagonal rows
    summing to ~2b: condition O(1)), from a numpy seed."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
    U = 0.5 * rng.standard_normal((N, max(S - 1, 0), b, b))
    Lo = 0.5 * rng.standard_normal((N, max(S - 1, 0), b, b))
    rhs = rng.standard_normal((N, S, b, t))
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (D, U, Lo, rhs)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(9, 21, 13, 12), (2, 1, 3, 1),
                                   (3, 101, 13, 12)])
def test_kernel_matches_twin_on_card(dtype, shape):
    """The kernel against its twin on the same CUDA inputs; one launch is
    counted.  Bounds: well-conditioned chains, so ~1e3 units of roundoff
    (float32 1e-4, float64 1e-12) for both the error and the residual."""
    _needs_card()
    dt = getattr(torch, dtype)
    D, U, Lo, rhs = _case(*shape, seed=shape[1], dtype=dt)
    before = band_qr.band_solve.launches
    x = band_qr.band_solve(D, U, Lo, rhs)
    torch.cuda.synchronize()
    assert band_qr.band_solve.launches == before + 1
    ref = band_qr.band_solve_qr_multi(D, U, Lo, rhs)
    tol = 1e-4 if dt == torch.float32 else 1e-12
    res = (band_matvec(D, U, Lo, x) - rhs).abs().max() / rhs.abs().max()
    assert float(res) < tol
    assert float((x - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input():
    _needs_card()
    D, U, Lo, rhs = _case(2, 4, 3, 2, seed=1, dtype=torch.float64)
    with pytest.raises(ValueError):
        band_qr.band_solve(D, U, Lo, rhs.transpose(2, 3).contiguous()
                           .transpose(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", [
    ((9, 21, 13, 12), None), ((2, 1, 3, 1), None), ((4, 21, 13, 12), None),
    ((3, 101, 13, 12), None), ((5, 21, 13, 12), 2)])
def test_tiled_kernel_matches_twin_on_card(shape, tile):
    """The tiled kernel (float32) against the plain version on the same
    CUDA inputs; one launch is counted.  (4, 21, ...) leaves two of the
    second block's three warps without a chain; S=101 keeps the factors
    in global memory; tile 2 forces two chains per block.  Bounds as for
    band_qr: 1e-4 for the error and the residual."""
    _needs_card()
    D, U, Lo, rhs = _case(*shape, seed=shape[1] + 1, dtype=torch.float32)
    before = band_qr.band_solve_tiled.launches
    x = band_qr.band_solve_tiled(D, U, Lo, rhs, chains_per_tile=tile)
    torch.cuda.synchronize()
    assert band_qr.band_solve_tiled.launches == before + 1
    ref = band_qr.band_solve_qr_multi(D, U, Lo, rhs)
    res = (band_matvec(D, U, Lo, x) - rhs).abs().max() / rhs.abs().max()
    assert float(res) < 1e-4
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.cuda
def test_tiled_kernel_rejects_float64_and_non_contiguous():
    _needs_card()
    D, U, Lo, rhs = _case(2, 4, 3, 2, seed=1, dtype=torch.float64)
    with pytest.raises(TypeError):
        band_qr.band_solve_tiled(D, U, Lo, rhs)
    D, U, Lo, rhs = (a.float() for a in (D, U, Lo, rhs))
    with pytest.raises(ValueError):
        band_qr.band_solve_tiled(D, U, Lo, rhs.transpose(2, 3).contiguous()
                                 .transpose(2, 3))
