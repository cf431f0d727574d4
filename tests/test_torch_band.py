"""Band sweep of the PyTorch port against the JAX package.

The port's chain sweep (``dompc_tpu_torch.solver.band_qr``) runs its plain
PyTorch twin on CPU tensors and the CUDA kernel on CUDA tensors.  Here the
twin is held against the JAX twin (``bbd.band_solve_qr_multi``, float64,
1e-12 relative: both are LAPACK Householder QR sweeps, so they differ only
by rounding) and against the Pallas lanes and tiled kernels in interpret
mode (float32, with the bounds ``tests/test_pallas_band.py`` itself uses).
The kernel-vs-twin checks need the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dompc_tpu.solver.bbd import band_solve_qr_multi as jax_band_multi
from dompc_tpu.solver.bbd import bbd_solve as jax_bbd_solve
from dompc_tpu.solver.pallas_band import (band_solve_qr_pallas,
                                          band_solve_qr_pallas_lanes)
from dompc_tpu_torch.solver import band_qr
from dompc_tpu_torch.solver.bbd import bbd_solve, bbd_matvec, band_matvec


def _case(N, S, b, t, seed):
    """Inputs of tests/test_pallas_band.py:_case, as numpy."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 4 * np.eye(b)
    U = rng.standard_normal((N, max(S - 1, 0), b, b))
    Lo = rng.standard_normal((N, max(S - 1, 0), b, b))
    rhs = rng.standard_normal((N, S, b, t))
    return D, U, Lo, rhs


def _torch(arrays, dtype):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def _resid(D, U, Lo, x, rhs):
    y = band_matvec(D, U, Lo, x)
    return float((y - rhs).abs().max() / rhs.abs().max())


@pytest.mark.parametrize("shape", [(3, 5, 4, 2), (2, 1, 3, 1), (2, 2, 3, 1),
                                   (4, 21, 13, 12), (1, 101, 6, 4)])
def test_twin_matches_jax_twin_f64(shape):
    arrays = _case(*shape, seed=sum(shape))
    ref = jax.vmap(jax_band_multi)(*[jnp.asarray(a) for a in arrays])
    got = band_qr.band_solve_qr_multi(*_torch(arrays, torch.float64))
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("shape,tile", [((3, 5, 4, 2), 8), ((2, 1, 3, 1), 8),
                                        ((5, 13, 7, 3), 8),
                                        ((5, 7, 5, 2), 4)])
def test_twin_matches_pallas_lanes_f32(shape, tile):
    # bound of tests/test_pallas_band.py:40,85 at the small shapes
    arrays = _case(*shape, seed=41 + shape[1])
    ref = band_solve_qr_pallas_lanes(
        *[jnp.asarray(a, jnp.float32) for a in arrays], lane_tile=tile,
        interpret=True)
    got = band_qr.band_solve_qr_multi(*_torch(arrays, torch.float32))
    assert _rel(got.numpy(), ref) < 5e-5


def test_twin_matches_pallas_lanes_flagship_f32():
    # random chains of the flagship length are ill-conditioned in float32:
    # tests/test_pallas_band.py:58-75 bounds the difference at 1e-2 and the
    # operator residual at 1e-3
    arrays = _case(3, 21, 13, 12, seed=62)
    ref = band_solve_qr_pallas_lanes(
        *[jnp.asarray(a, jnp.float32) for a in arrays], lane_tile=8,
        interpret=True)
    D, U, Lo, rhs = _torch(arrays, torch.float32)
    got = band_qr.band_solve_qr_multi(D, U, Lo, rhs)
    assert _rel(got.numpy(), ref) < 1e-2
    assert _resid(D, U, Lo, got, rhs) < 1e-3


def test_twin_extreme_scales_f32():
    """Barrier diagonals reach ~1e22 in float32 KKT systems
    (tests/test_pallas_band.py:126-147): the solve stays finite and the
    operator residual small."""
    D, U, Lo, rhs = _case(2, 6, 5, 2, seed=3)
    D[:, :, 0, 0] = 1e22
    D, U, Lo, rhs = _torch((D, U, Lo, rhs), torch.float32)
    got = band_qr.band_solve_qr_multi(D, U, Lo, rhs)
    assert bool(torch.isfinite(got).all())
    assert _resid(D, U, Lo, got, rhs) < 1e-3


def test_band_solve_on_cpu_is_the_twin_and_counts_nothing():
    D, U, Lo, rhs = _torch(_case(2, 4, 3, 2, seed=5), torch.float64)
    before = band_qr.band_solve.launches
    got = band_qr.band_solve(D, U, Lo, rhs)
    assert band_qr.band_solve.launches == before
    assert torch.equal(got, band_qr.band_solve_qr_multi(D, U, Lo, rhs))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_band_solve_rejects_bad_inputs(bad):
    D, U, Lo, rhs = _torch(_case(2, 4, 3, 2, seed=5), torch.float64)
    if bad == "shape":
        with pytest.raises(ValueError):
            band_qr.band_solve(D, U[:, :2], Lo, rhs)
    else:
        with pytest.raises(TypeError):
            band_qr.band_solve(D, U.float(), Lo, rhs)


def _bbd_case(C, S, b, R, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((C, S, b, b)) + 6 * np.eye(b)
    U = 0.5 * rng.standard_normal((C, S - 1, b, b))
    Lo = 0.5 * rng.standard_normal((C, S - 1, b, b))
    Bord = 0.3 * rng.standard_normal((C, S, b, R))
    Root = rng.standard_normal((R, R)) + 10 * np.eye(R)
    rhs_c = rng.standard_normal((C, S, b))
    rhs_r = rng.standard_normal(R)
    return D, U, Lo, Bord, Root, rhs_c, rhs_r


@pytest.mark.parametrize("R", [0, 3])
def test_bbd_solve_refined_matches_jax_f64(R):
    arrays = _bbd_case(4, 9, 5, R, seed=11 + R)
    xc_j, xr_j = jax_bbd_solve(*[jnp.asarray(a) for a in arrays],
                               n_refine=1)
    targs = _torch(arrays, torch.float64)
    xc, xr = bbd_solve(*targs, n_refine=1)
    assert _rel(xc.numpy(), xc_j) <= 1e-12
    if R:
        assert _rel(xr.numpy(), xr_j) <= 1e-12
    # and the refined solution solves the system
    y_c, y_r = bbd_matvec(*targs[:5], xc, xr)
    assert float((y_c - targs[5]).abs().max()) < 1e-12


def test_bbd_solve_refuses_spike_length_chains():
    arrays = _bbd_case(1, 48, 2, 1, seed=1)
    with pytest.raises(NotImplementedError):
        bbd_solve(*_torch(arrays, torch.float64))


@pytest.mark.parametrize("shape", [(3, 5, 4, 2), (2, 1, 3, 1), (5, 13, 7, 3),
                                   (3, 4, 5, 2)])
def test_tiled_plain_version_matches_pallas_tiled_f32(shape):
    """``band_solve_tiled`` on the CPU (the plain version) against the TPU
    kernel ``_band_sweep_kernel`` in interpret mode, 2 chains per tile (N=3
    and N=5 pad the last tile), at the shapes and bound of
    tests/test_pallas_band.py:32-50.  The chains are diagonally dominant
    (condition O(1)): with that file's inputs (diagonal 4) the float32
    solutions at (5, 13, 7, 3) sit 5e-5 to 9e-5 from the float64 one for
    every solver, LAPACK's and the Pallas sweep alike, so two independent
    float32 sweeps cannot agree to 5e-5 there."""
    N, S, b, t = shape
    rng = np.random.default_rng(sum(shape))
    D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
    U = 0.5 * rng.standard_normal((N, S - 1, b, b))
    Lo = 0.5 * rng.standard_normal((N, S - 1, b, b))
    rhs = rng.standard_normal((N, S, b, t))
    arrays = [a.astype(np.float32) for a in (D, U, Lo, rhs)]
    ref = band_solve_qr_pallas(*map(jnp.asarray, arrays), chains_per_tile=2,
                               interpret=True)
    got = band_qr.band_solve_tiled(*map(torch.as_tensor, arrays))
    assert _rel(got.numpy(), ref) < 5e-5


def test_band_solve_tiled_on_cpu_and_its_checks():
    D, U, Lo, rhs = _torch(_case(2, 4, 3, 2, seed=5), torch.float32)
    before = band_qr.band_solve_tiled.launches
    got = band_qr.band_solve_tiled(D, U, Lo, rhs, chains_per_tile=2)
    assert band_qr.band_solve_tiled.launches == before
    assert torch.equal(got, band_qr.band_solve_qr_multi(D, U, Lo, rhs))
    with pytest.raises(TypeError):      # float32 only, as pallas_band.py
        band_qr.band_solve_tiled(D.double(), U.double(), Lo.double(),
                                 rhs.double())
    with pytest.raises(ValueError):
        band_qr.band_solve_tiled(D, U[:, :2], Lo, rhs)


def test_tiled_plan_layouts():
    """The launch layouts the tiled kernel gets: at the flagship the
    factors of G=3 chains fit in a block's 227 KB (G=4 would not); at
    S=101 one chain's factors (265 KB) do not, so they go to a global
    scratch."""
    assert band_qr.tiled_plan(21, 13, 12) == (3, True, 3 * 4 * 15080)
    G, f_smem, smem = band_qr.tiled_plan(101, 13, 12)
    assert (G, f_smem) == (band_qr.TILED_MAX_G, False)
    assert smem <= band_qr.SMEM_MAX
    assert band_qr.tiled_plan(21, 13, 12, chains_per_tile=4)[1] is False
    with pytest.raises(ValueError):
        band_qr.tiled_plan(21, 13, 12, chains_per_tile=0)


def test_bbd_solve_tiled_takes_long_chains_f32(monkeypatch):
    """S >= 48 in float32: the tiled backend solves (JAX takes it before
    the SPIKE partition, bbd.py:868-873), with the partition heuristic's
    side effect of two refinement passes (bbd.py:842-846); the default
    backend still refuses, SPIKE being unported, unless the float32
    heuristic is switched off (DOMPC_TPU_SPIKE_F32_REFINE=0)."""
    monkeypatch.delenv("DOMPC_TPU_SPIKE", raising=False)
    monkeypatch.delenv("DOMPC_TPU_SPIKE_F32_REFINE", raising=False)
    arrays = _bbd_case(2, 50, 3, 2, seed=7)
    targs = _torch(arrays, torch.float32)
    calls = []

    def counting(*args):
        calls.append(1)
        return band_qr.band_solve_qr_multi(*args)

    monkeypatch.setattr(band_qr, "band_solve_tiled", counting)
    xc, xr = bbd_solve(*targs, backend="pallas_tiled")
    assert len(calls) == 3                 # one sweep + 2 refinement passes
    y_c, y_r = bbd_matvec(*targs[:5], xc, xr)
    assert float((y_c - targs[5]).abs().max()) < 1e-4
    with pytest.raises(NotImplementedError):
        bbd_solve(*targs)
    monkeypatch.setenv("DOMPC_TPU_SPIKE_F32_REFINE", "0")
    xc0, _ = bbd_solve(*targs)
    assert _rel(xc0.numpy(), xc.numpy()) < 1e-4
