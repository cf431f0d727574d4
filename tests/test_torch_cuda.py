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


def _case(N, S, b, t, seed, dtype, huge=False):
    """Diagonally dominant chains (|diag| 3b against off-diagonal rows
    summing to ~2b: condition O(1)), from a numpy seed; ``huge`` puts a
    1e22 barrier-style entry on every diagonal block."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
    U = 0.5 * rng.standard_normal((N, max(S - 1, 0), b, b))
    Lo = 0.5 * rng.standard_normal((N, max(S - 1, 0), b, b))
    rhs = rng.standard_normal((N, S, b, t))
    if huge:
        D[:, :, 0, 0] = 1e22
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (D, U, Lo, rhs)]


def _errors(D, U, Lo, rhs, x):
    """(operator residual, error against the plain version on a CPU copy)
    relative to max |rhs| and max |x|.  The plain version runs on the CPU:
    on the card its batched torch.linalg.qr overflows in float32 on a 1e22
    diagonal (chip_smoke.py)."""
    ref = band_qr.band_solve_qr_multi(*[a.cpu() for a in (D, U, Lo, rhs)])
    res = (band_matvec(D, U, Lo, x) - rhs).abs().max() / rhs.abs().max()
    err = (x.cpu() - ref).abs().max() / ref.abs().max()
    return float(res), float(err)


# Shapes on both sides of each row-bucket edge (b = 4|5, 8|9, 13|14,
# 16|17, 32|33) and of the chunk edges in 3b + t (band_qr: a block holds
# 256 columns, so 3b + t = 256|257 at b = 13; the tiled kernel: a lane of
# bucket 13 holds 2 columns, so 3b + t = 64|65), S = 1 and S = 2.
EDGE_SHAPES = [(3, 5, 4, 2), (3, 5, 5, 2), (2, 4, 8, 3), (2, 4, 9, 3),
               (2, 6, 13, 12), (2, 6, 14, 12), (2, 4, 16, 5), (2, 4, 17, 5),
               (1, 3, 32, 4), (1, 3, 33, 4), (2, 3, 13, 25), (2, 3, 13, 26),
               (1, 3, 13, 217), (1, 3, 13, 218), (2, 1, 13, 12),
               (2, 2, 13, 12), (2, 1, 3, 1), (2, 2, 3, 1)]


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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_kernel_bucket_and_chunk_edges_on_card(dtype, shape):
    """band_qr on both sides of every row-bucket and chunk edge, and at
    S = 1 and 2: the bounds of test_kernel_matches_twin_on_card."""
    _needs_card()
    dt = getattr(torch, dtype)
    D, U, Lo, rhs = _case(*shape, seed=sum(shape), dtype=dt)
    res, err = _errors(D, U, Lo, rhs, band_qr.band_solve(D, U, Lo, rhs))
    tol = 1e-4 if dt == torch.float32 else 1e-12
    assert res < tol and err < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_tiled_kernel_bucket_and_chunk_edges_on_card(shape):
    """The tiled kernel on the same edges (float32 bounds as above)."""
    _needs_card()
    D, U, Lo, rhs = _case(*shape, seed=sum(shape) + 1, dtype=torch.float32)
    res, err = _errors(D, U, Lo, rhs,
                       band_qr.band_solve_tiled(D, U, Lo, rhs))
    assert res < 1e-4 and err < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["band_qr", "band_sweep_tiled"])
def test_kernels_huge_diagonal_on_card(kernel):
    """A 1e22 diagonal entry in float32 (tests/test_pallas_band.py:126-147):
    finite, residual below 1e-3, as the plain version on the CPU."""
    _needs_card()
    D, U, Lo, rhs = _case(9, 21, 13, 12, seed=7, dtype=torch.float32,
                          huge=True)
    fn = band_qr.band_solve if kernel == "band_qr" \
        else band_qr.band_solve_tiled
    x = fn(D, U, Lo, rhs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    res, err = _errors(D, U, Lo, rhs, x)
    assert res < 1e-3 and err < 1e-3


@pytest.mark.cuda
def test_kernel_widest_bucket_f64_on_card():
    """float64 at the widest panel the wrapper takes in float64 (b = 69,
    row bucket 97, one staging buffer): the float64 bounds."""
    _needs_card()
    D, U, Lo, rhs = _case(2, 3, 69, 1, seed=69, dtype=torch.float64)
    assert band_qr.qr_plan(69, 1, torch.float64).rows == 97
    res, err = _errors(D, U, Lo, rhs, band_qr.band_solve(D, U, Lo, rhs))
    assert res < 1e-12 and err < 1e-12


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input():
    _needs_card()
    D, U, Lo, rhs = _case(2, 4, 3, 2, seed=1, dtype=torch.float64)
    with pytest.raises(ValueError):
        band_qr.band_solve(D, U, Lo, rhs.transpose(2, 3).contiguous()
                           .transpose(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", [
    ((9, 21, 13, 12), None), ((2, 1, 3, 1), None), ((5, 21, 13, 12), None),
    ((3, 101, 13, 12), None), ((5, 21, 13, 12), 2)])
def test_tiled_kernel_matches_twin_on_card(shape, tile):
    """The tiled kernel (float32) against the plain version on the same
    CUDA inputs; one launch is counted.  (5, 21, ...) leaves three of the
    second block's four warps without a chain; tile 2 forces two chains
    per block.  Bounds as for band_qr: 1e-4 for the error and the
    residual."""
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
def test_scatter_sum_cols_is_deterministic_on_card():
    """The KKT assembly's scatter gives the same bits every call on the
    card (index_add's atomics would not), so two solves of the same
    problems round alike."""
    from dompc_tpu_torch.solver.bbd import scatter_sum_cols
    _needs_card()
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(rng.integers(0, 50, 200_000), device="cuda")
    src = torch.as_tensor(rng.standard_normal((128, 200_000)),
                          dtype=torch.float32, device="cuda")
    first = scatter_sum_cols(idx, src, 50)
    assert all(torch.equal(first, scatter_sum_cols(idx, src, 50))
               for _ in range(3))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,P", [((1, 101, 23, 1), 13),
                                     ((1, 101, 23, 47), 13),
                                     ((2, 50, 4, 3), 6)])
def test_kernel_spike_matches_plain_spike_on_card(dtype, shape, P):
    """SPIKE with the kernel as its sweep (two launches: the N*P segments,
    then the reduced separator system) against the plain SPIKE on a CPU
    copy, at the DIP's chain (1, 101, 23, P=13: segments (13, 7, 23, 2b+t),
    reduced (1, 12, 23, t)); the bounds of
    test_kernel_matches_twin_on_card."""
    from dompc_tpu_torch.solver import batchqr
    _needs_card()
    dt = getattr(torch, dtype)
    D, U, Lo, rhs = _case(*shape, seed=sum(shape), dtype=dt)
    before = band_qr.band_solve.launches
    x = batchqr.band_solve_spike_impl(D, U, Lo, rhs, P)
    torch.cuda.synchronize()
    assert band_qr.band_solve.launches == before + 2
    ref = batchqr.band_solve_spike_impl(*[a.cpu() for a in (D, U, Lo, rhs)],
                                        P)
    tol = 1e-4 if dt == torch.float32 else 1e-12
    res = (band_matvec(D, U, Lo, x) - rhs).abs().max() / rhs.abs().max()
    assert float(res) < tol
    assert float((x.cpu() - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bbd_solve_long_chain_takes_spike_on_card(monkeypatch, dtype):
    """On the card a chain of S=101 is partitioned: 2 launches a sweep,
    times 1 + n_refine (float32: the 2 passes of the partition heuristic);
    DOMPC_TPU_SPIKE=0 sweeps it whole, one launch a sweep."""
    from dompc_tpu_torch.solver.bbd import bbd_solve, bbd_matvec
    _needs_card()
    for var in ("DOMPC_TPU_SPIKE", "DOMPC_TPU_SPIKE_F32_REFINE",
                "DOMPC_TPU_BAND_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    dt = getattr(torch, dtype)
    D, U, Lo, rhs = _case(1, 101, 23, 1, seed=7, dtype=dt)
    rng = np.random.default_rng(8)
    Bord = torch.as_tensor(0.3 * rng.standard_normal((1, 101, 23, 2)),
                           dtype=dt, device="cuda")
    Root = torch.as_tensor(rng.standard_normal((2, 2)) + 10 * np.eye(2),
                           dtype=dt, device="cuda")
    rhs_c, rhs_r = rhs[..., 0], torch.ones(2, dtype=dt, device="cuda")
    n_refine = 1 if dtype == "float64" else 0
    passes = {"float64": 2, "float32": 3}[dtype]
    sols = []
    for spike, per_pass in (("", 2), ("0", 1)):
        monkeypatch.setenv("DOMPC_TPU_SPIKE", spike)
        before = band_qr.band_solve.launches
        xc, xr = bbd_solve(D, U, Lo, Bord, Root, rhs_c, rhs_r,
                           n_refine=n_refine)
        torch.cuda.synchronize()
        want = per_pass * (passes if spike == "" else 1 + n_refine)
        assert band_qr.band_solve.launches - before == want
        y_c, y_r = bbd_matvec(D, U, Lo, Bord, Root, xc, xr)
        tol = 1e-4 if dt == torch.float32 else 1e-12
        assert float((y_c - rhs_c).abs().max()) < tol
        sols.append(xc)
    assert float((sols[0] - sols[1]).abs().max()) < (
        1e-4 if dt == torch.float32 else 1e-12)
