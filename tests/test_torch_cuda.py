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
    """float64 at b = 69 (row bucket 97, band_qr_wide): the float64
    bounds."""
    _needs_card()
    D, U, Lo, rhs = _case(2, 3, 69, 1, seed=69, dtype=torch.float64)
    assert band_qr.qr_plan(69, 1, torch.float64).rows == 97
    res, err = _errors(D, U, Lo, rhs, band_qr.band_solve(D, U, Lo, rhs))
    assert res < 1e-12 and err < 1e-12


# band_qr_wide's shapes: both buckets and their edges (b = 32|33, 64|65,
# 97), S = 1, 2 and long, one right-hand side to many (2b + t: a SPIKE
# segment of the MHE's b=83 chain), 16- and 32-column tiles in float64
WIDE_SHAPES = [(1, 3, 33, 4), (2, 4, 64, 3), (2, 4, 65, 3), (1, 11, 83, 2),
               (2, 3, 97, 1), (1, 1, 50, 3), (2, 2, 50, 3), (6, 8, 83, 168),
               (1, 5, 84, 24), (1, 21, 40, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_kernel_matches_twin_on_card(dtype, shape):
    """band_solve above b = 32 launches band_qr_wide (counted in both
    launches and wide_launches) and agrees with the plain version on a CPU
    copy within the bounds of test_kernel_matches_twin_on_card."""
    _needs_card()
    dt = getattr(torch, dtype)
    D, U, Lo, rhs = _case(*shape, seed=sum(shape) + 3, dtype=dt)
    before = (band_qr.band_solve.launches, band_qr.band_solve.wide_launches)
    x = band_qr.band_solve(D, U, Lo, rhs)
    torch.cuda.synchronize()
    assert (band_qr.band_solve.launches,
            band_qr.band_solve.wide_launches) == (before[0] + 1,
                                                  before[1] + 1)
    res, err = _errors(D, U, Lo, rhs, x)
    tol = 1e-4 if dt == torch.float32 else 1e-12
    assert res < tol and err < tol


@pytest.mark.cuda
def test_wide_kernel_huge_diagonal_and_counter_on_card():
    """band_qr_wide with a 1e22 diagonal in float32 at the MHE's band:
    finite, residual and error below 1e-3; a narrow band (b = 13) counts
    in launches only."""
    _needs_card()
    D, U, Lo, rhs = _case(1, 11, 83, 2, seed=83, dtype=torch.float32,
                          huge=True)
    x = band_qr.band_solve(D, U, Lo, rhs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    res, err = _errors(D, U, Lo, rhs, x)
    assert res < 1e-3 and err < 1e-3
    before = (band_qr.band_solve.launches, band_qr.band_solve.wide_launches)
    band_qr.band_solve(*_case(9, 21, 13, 12, seed=1, dtype=torch.float32))
    assert (band_qr.band_solve.launches,
            band_qr.band_solve.wide_launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        band_qr.launcher("band_qr", *_case(1, 2, 40, 1, seed=2,
                                           dtype=torch.float32))


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


# The tiled kernel's redesigned buckets: 32 (b = 17..32, a block of a few
# warps a chain) and 64, 97 (b = 33..97, a block of 512 a chain): every b
# from b = 17 to 97 that a path or an edge names, S = 1 and 2, t across
# bucket 32's chunk edge (3b + t = 256 | 257 at b = 17), odd N (one chain
# a block here; N not a multiple of G is test_tiled_kernel_matches_twin_
# on_card's (5, 21, 13, 12) at bucket 13)
TILED_WIDE_SHAPES = [(3, 5, 17, 2), (1, 3, 17, 205), (1, 3, 17, 206),
                     (3, 4, 23, 1), (2, 1, 23, 3), (13, 7, 23, 47),
                     (3, 2, 32, 4), (2, 3, 33, 2), (1, 11, 50, 2),
                     (1, 11, 83, 2), (2, 1, 83, 2), (2, 2, 97, 1),
                     (1, 3, 97, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TILED_WIDE_SHAPES)
@pytest.mark.parametrize("tile", [None, "most"])
def test_tiled_kernel_wide_bands_on_card(shape, tile):
    """band_solve_tiled at b = 17..97 against the plain version on a CPU
    copy and against band_solve on the same inputs (1e-4, as for b <= 16),
    one launch counted; ``most``: the most chains a block the bucket
    allows (1 at b >= 17)."""
    _needs_card()
    D, U, Lo, rhs = _case(*shape, seed=sum(shape) + 5, dtype=torch.float32)
    G = None if tile is None else 1
    before = band_qr.band_solve_tiled.launches
    x = band_qr.band_solve_tiled(D, U, Lo, rhs, chains_per_tile=G)
    torch.cuda.synchronize()
    assert band_qr.band_solve_tiled.launches == before + 1
    res, err = _errors(D, U, Lo, rhs, x)
    assert res < 1e-4 and err < 1e-4
    y = band_qr.band_solve(D, U, Lo, rhs)
    assert float((x - y).abs().max() / y.abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 12, 23, 1), (1, 11, 83, 2)])
def test_tiled_kernel_wide_bands_huge_diagonal_on_card(shape):
    """A 1e22 diagonal at b = 23 (bucket 32) and 83 (bucket 97), float32:
    finite, residual and error below 1e-3 (tests/test_pallas_band.py:
    126-147)."""
    _needs_card()
    D, U, Lo, rhs = _case(*shape, seed=shape[2], dtype=torch.float32,
                          huge=True)
    x = band_qr.band_solve_tiled(D, U, Lo, rhs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    res, err = _errors(D, U, Lo, rhs, x)
    assert res < 1e-3 and err < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,G", [(23, 3), (17, 5), (17, 2), (32, 2),
                                 (50, 2), (83, 2)])
def test_tiled_kernel_refuses_too_many_chains_a_block_on_card(b, G):
    """chains_per_tile beyond what the bucket allows raises before any
    launch (buckets 32, 64 and 97: one chain a block)."""
    _needs_card()
    args = _case(2, 3, b, 2, seed=b, dtype=torch.float32)
    before = band_qr.band_solve_tiled.launches
    with pytest.raises(ValueError):
        band_qr.band_solve_tiled(*args, chains_per_tile=G)
    assert band_qr.band_solve_tiled.launches == before


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


@pytest.mark.cuda
def test_bbd_solve_wide_band_takes_plain_route_on_card():
    """b = 100 exceeds the widest row bucket (97): bbd_solve takes the plain
    sweep on the card, decided from the shape (no kernel launch, one plain
    route counted), and equals the CPU solve."""
    from dompc_tpu_torch.solver.bbd import bbd_solve
    _needs_card()
    D, U, Lo, rhs = _case(2, 6, 100, 2, seed=100, dtype=torch.float64)
    Bord, rhs_c = rhs[..., :1], rhs[..., 1]
    Root = torch.full((1, 1), 10.0, dtype=torch.float64, device="cuda")
    rhs_r = torch.ones(1, dtype=torch.float64, device="cuda")
    before = (band_qr.band_solve.launches, bbd_solve.plain_routes)
    with pytest.warns(UserWarning, match="widest row bucket"):
        xc, xr = bbd_solve(D, U, Lo, Bord, Root, rhs_c, rhs_r)
    torch.cuda.synchronize()
    assert band_qr.band_solve.launches == before[0]
    assert bbd_solve.plain_routes == before[1] + 1
    xc_ref, xr_ref = bbd_solve(*[a.cpu() for a in (D, U, Lo, Bord, Root,
                                                   rhs_c, rhs_r)])
    assert float((xc.cpu() - xc_ref).abs().max()) < 1e-12
    assert float((xr.cpu() - xr_ref).abs().max()) < 1e-12


def _port_env(monkeypatch, platform=None, x64=True):
    """Select the port's device and dtype for what is set up next."""
    for var, val in (("DOMPC_TPU_PLATFORM", platform),
                     ("DOMPC_TPU_X64", "1" if x64 else None)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)


def _masses_mpc(ub_u):
    """The oscillating masses (N=7) with the nl_cons u <= 0.3; with ub_u =
    0.3 the nl_cons duplicates the active input bound and the sensitivity
    system is exactly singular."""
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch.systems import oscillating_masses_model
    model = oscillating_masses_model()
    mpc = tdm.controller.MPC(model)
    mpc.settings.n_horizon = 7
    mpc.settings.t_step = 0.5
    mpc.set_objective(mterm=model.aux["cost"], lterm=model.aux["cost"])
    mpc.set_rterm(u=1e-4)
    max_x = np.array([[4.0], [10.0], [4.0], [10.0]])
    mpc.bounds["lower", "_x", "x"] = -max_x
    mpc.bounds["upper", "_x", "x"] = max_x
    mpc.bounds["lower", "_u", "u"] = -0.5
    mpc.bounds["upper", "_u", "u"] = ub_u
    mpc.set_nl_cons("ulim", model.u["u"], ub=0.3)
    mpc.setup()
    return mpc


@pytest.mark.cuda
@pytest.mark.parametrize("ub_u", [0.5, 0.3])
def test_differentiator_on_card_matches_cpu(monkeypatch, ub_u):
    """The sensitivity system assembled and solved on the card (float64):
    the LU solve (active nl_cons) and the least-squares fallback (an exactly
    singular system) against the port on the CPU at the same solution, to
    1e-10."""
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch.interop import mpc_state_arrays, load_mpc_state
    _needs_card()
    _port_env(monkeypatch)
    card = _masses_mpc(ub_u)
    assert card._device.type == "cuda" and card._dtype == torch.float64
    # tests/test_satellites.py's state, where u0 wants more than 0.3
    x0 = np.random.RandomState(99).rand(4) - 0.5
    card.x0 = x0
    card.set_initial_guess()
    card.make_step(x0)
    _port_env(monkeypatch, "cpu")
    cpu = _masses_mpc(ub_u)
    load_mpc_state(cpu, mpc_state_arrays(card))
    out = []
    for mpc in (card, cpu):
        diff = tdm.differentiator.DoMPCDifferentiator(mpc)
        diff.settings.check_LICQ = True
        dx_dp, dlam_dp = diff.differentiate()
        out.append((dx_dp, dlam_dp, diff.status, diff.active_sets))
    (cx, cl, cs, ca), (px, pl, ps, pa) = out
    for key in ca:
        np.testing.assert_array_equal(ca[key], pa[key])
    assert cs.LICQ == ps.LICQ == (ub_u != 0.3)
    assert cs.residuals < 1e-10
    assert np.max(np.abs(cx - px)) <= 1e-10 * max(1.0, np.max(np.abs(px)))
    assert np.max(np.abs(cl - pl)) <= 1e-10 * max(1.0, np.max(np.abs(pl)))


@pytest.mark.cuda
def test_sample_batched_on_card(monkeypatch, tmp_path):
    """Sampler.sample_batched stacks the plan on the card and vmaps the
    sample function there; the results equal the sequential samples."""
    import dompc_tpu_torch as tdm
    _needs_card()
    _port_env(monkeypatch)
    plan = [{"id": str(i).zfill(3), "alpha": float(a), "beta": int(b)}
            for i, (a, b) in enumerate(zip(np.linspace(-1, 1, 9),
                                           range(9)))]
    seen = []

    def fun(alpha, beta):
        seen.append(alpha.device)
        return {"prod": alpha * beta, "cube": alpha ** 3}

    sampler = tdm.sampling.Sampler(plan, print_progress=False,
                                   data_dir=str(tmp_path) + "/")
    sampler.set_sample_function(fun)
    res = sampler.sample_batched()
    assert seen and all(d.type == "cuda" for d in seen)
    want = np.array([c["alpha"] * c["beta"] for c in plan])
    np.testing.assert_allclose(res["prod"], want, rtol=1e-15)
    for c in plan:
        got = tdm.tools.load_pickle(str(tmp_path / f"sample_{c['id']}"))
        assert abs(got["cube"] - c["alpha"] ** 3) < 1e-15


@pytest.mark.cuda
def test_trainer_epoch_on_card_matches_cpu(monkeypatch):
    """One Trainer epoch on the card against the same epoch on the CPU,
    same initial weights, same data (float32): losses to 1e-5 relative."""
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch.systems import (oscillating_masses_model,
                                         oscillating_masses_mpc)
    _needs_card()
    _port_env(monkeypatch, x64=False)
    mpc = oscillating_masses_mpc(oscillating_masses_model())
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, (256, 4))
    U_prev = rng.uniform(-0.4, 0.4, (256, 1))
    U = np.clip(-0.3 * X[:, :1] + 0.1 * U_prev, -0.5, 0.5)
    hist = []
    for device in ("cuda", "cpu"):
        approx = tdm.approximateMPC.ApproxMPC(mpc)
        approx.net.to(device)
        assert approx.device.type == device
        st = tdm.approximateMPC.TrainerSettings(
            n_epochs=1, batch_size=32, learning_rate=3e-3,
            print_frequency=0)
        hist.append(tdm.approximateMPC.Trainer(approx, st).default_training(
            X, U, U_prev=U_prev, seed=0))
    for key in ("train_loss", "val_loss", "update_norm"):
        np.testing.assert_allclose(hist[0][key], hist[1][key], rtol=1e-5,
                                   err_msg=key)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_one_rank_nccl_sharded_matches_batch_on_card(monkeypatch):
    """``init_distributed`` makes a one-rank NCCL group on the card and
    ``make_sharded_solver`` then equals ``make_batch_solver`` on the whole
    batch (the oscillating masses, float64, B=8): u0 to 1e-12, the same
    iterations, n_ok = B."""
    import torch.distributed as dist
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch.parallel import (init_distributed,
                                          make_sharded_solver,
                                          make_batch_solver,
                                          initial_guess_from_x0)
    _needs_card()
    _port_env(monkeypatch)
    mpc = tdm.systems.oscillating_masses_mpc(
        tdm.systems.oscillating_masses_model())
    x0s = 0.4 * np.random.default_rng(0).standard_normal((8, 4))
    w0s = initial_guess_from_x0(mpc, x0s)
    assert init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        solve, mesh = make_sharded_solver(mpc, tol=1e-6,
                                          throughput_mode=True)
        u, it, n_ok = solve(x0s, w0s)
    finally:
        dist.destroy_process_group()
    sol, u_ref = make_batch_solver(mpc, tol=1e-6, throughput_mode=True)(
        x0s, w0s)
    assert u.device.type == "cuda" and float(n_ok) == 8
    assert torch.equal(it, sol.iterations)
    assert float((u - u_ref).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_trace_counts_band_qr_on_card(monkeypatch, tmp_path):
    """A profiled warm batched call (the oscillating masses through the
    structured KKT, float32) writes a trace whose band_qr kernel events
    equal the wrapper's launches; the device-memory snapshot is
    non-empty."""
    import json
    import pickle
    import dompc_tpu_torch as tdm
    from dompc_tpu_torch.parallel import (make_batch_solver,
                                          initial_guess_from_x0)
    from dompc_tpu_torch.tools import profiler
    _needs_card()
    _port_env(monkeypatch, x64=False)
    mpc = tdm.systems.oscillating_masses_mpc(
        tdm.systems.oscillating_masses_model())
    x0s = 0.4 * np.random.default_rng(0).standard_normal((8, 4))
    solve = make_batch_solver(mpc, tol=1e-3, throughput_mode=True)
    sol, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
    before = band_qr.band_solve.launches
    with profiler.trace(str(tmp_path)):
        with profiler.annotate("unit.warm_call"):
            solve(x0s * 1.001, sol.w, sol.lam, 1e-4, sol.zl, sol.zu)
            torch.cuda.synchronize()
    launches = band_qr.band_solve.launches - before
    assert launches > 0
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "unit.warm_call" for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "band_qr" in e.get("name", "")]
    assert len(kernels) == launches
    mem = tmp_path / "mem.pkl"
    profiler.save_device_memory_profile(str(mem))
    with open(mem, "rb") as f:
        assert pickle.load(f)["segments"]


@pytest.mark.cuda
def test_structured_and_onnx_ops_on_card_match_cpu():
    """``solver.structured`` and ``sysid.ONNXOperations`` on CUDA tensors
    equal the same calls on CPU tensors (float64, 1e-12)."""
    from types import SimpleNamespace
    from dompc_tpu_torch.solver import structured
    from dompc_tpu_torch.sysid import ONNXOperations
    _needs_card()
    ops = ONNXOperations()
    rng = np.random.default_rng(5)
    S, b = 21, 13
    D = rng.standard_normal((S, b, b)) + 3.0 * b * np.eye(b)
    U, Lo = rng.standard_normal((2, S - 1, b, b))
    rhs = rng.standard_normal((S, b))
    X, W = rng.standard_normal((4, 6)), rng.standard_normal((6, 3))
    gemm_attr = [SimpleNamespace(name="alpha", f=0.5),
                 SimpleNamespace(name="transA", i=1)]

    def run(device):
        def T(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)
        band = [T(a) for a in (D, U, Lo)]
        outs = [structured.band_matvec(*band, T(rhs)),
                structured.band_solve(structured.band_factor(*band),
                                      band[1], band[2], T(rhs)),
                structured.band_solve_qr(*band, T(rhs)),
                ops.Tanh(T(X)), ops.Sigmoid(T(X)), ops.Relu(T(X)),
                ops.Elu(T(X)), ops.MatMul(T(X), T(W)),
                ops.Add(T(X), T(X), 1.0), ops.Gemm(T(X), T(X),
                                                   attribute=gemm_attr),
                ops.Concat(T(X), T(X)), ops.Unsqueeze(T(X), axes=[1]),
                ops.Slice(T(X), [3], [0], axes=[0], steps=[-1]),
                ops.Reshape(T(X), np.array([2, -1]))]
        assert all(o.device.type == device for o in outs)
        return [o.cpu().numpy() for o in outs]

    for got, ref in zip(run("cuda"), run("cpu")):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


# -- the port's spans on the card ----------------------------------------------

def _kineto(prof):
    """(host annotation ranges, device operations) of a stopped profiler,
    each as sorted (name, start_ns, end_ns) on the profiler's clock."""
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    ranges, ops = [], []
    for e in prof.profiler.kineto_results.events():
        r = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.is_user_annotation():
            if e.device_type() == cpu:
                ranges.append(r)
        elif e.device_type() == cuda:
            ops.append(r)
    return sorted(ranges, key=lambda r: (r[1], -r[2])), sorted(ops)


@pytest.fixture(scope="module")
def warm_call_on_card():
    """One warm float32 throughput-mode call of the robust CSTR (N = 20) at
    B = 256, traced (host ranges and CUDA events) under
    ``torch.cuda.set_sync_debug_mode("warn")``: the trace, the sync
    warnings raised inside ``solve_batch`` and the helper's own count."""
    import warnings
    from dompc_tpu_torch.parallel import (make_batch_solver,
                                          initial_guess_from_x0)
    from dompc_tpu_torch.systems import bench_states, cstr_robust_mpc
    from dompc_tpu_torch.tools import profiler
    _needs_card()
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, x64=False)
        mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    solve = make_batch_solver(mpc, tol=1e-3, max_iter=60,
                              throughput_mode=True)
    x0s = bench_states(256)
    cold, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
    warm, _ = solve(x0s * 1.001, cold.w, cold.lam, 1e-4, cold.zl, cold.zu)
    torch.cuda.synchronize()
    count0 = profiler.host_sync.count
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sol, _ = solve(x0s * 1.002, warm.w, warm.lam, 1e-4, warm.zl,
                               warm.zu)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    ranges, ops = _kineto(prof)
    return dict(ranges=ranges, ops=ops,
                warnings=[w for w in caught if "called a synchronizing"
                          in str(w.message)],
                syncs=profiler.host_sync.count - count0,
                success=bool(sol.success.all()))


@pytest.mark.cuda
def test_sync_warnings_equal_sync_spans_on_card(warm_call_on_card):
    """Every blocking read inside ``solve_batch`` opens one ``sync.*``
    span: torch's sync warnings, the spans and the helper's count agree."""
    got = warm_call_on_card
    assert got["success"]
    spans = [r for r in got["ranges"] if r[0].startswith("sync.")]
    sites = [f"{w.filename}:{w.lineno}" for w in got["warnings"]]
    assert len(got["warnings"]) == len(spans) == got["syncs"] > 0, (
        sites, [r[0] for r in spans])


@pytest.mark.cuda
def test_sync_spans_close_after_the_queue_drains_on_card(warm_call_on_card):
    """One clock for host spans and device events: a sync cannot return
    before the card has drained its queue, so every device operation that
    starts before a ``sync.*`` span opens ends before the span closes
    (20 us allowed)."""
    got = warm_call_on_card
    spans = [r for r in got["ranges"] if r[0].startswith("sync.")]
    assert spans and got["ops"]
    for name, s, e in spans:
        late = [op for op in got["ops"] if op[1] < s and op[2] > e + 20_000]
        assert not late, (name, s, e, late[:3])


def _covered(ranges, parent, children):
    """Share of the ``parent`` ranges' time that their ``children`` ranges
    cover (children of one thread do not overlap)."""
    total = covered = 0
    for name, s, e in ranges:
        if name == parent:
            total += e - s
            covered += sum(b - a for n, a, b in ranges
                           if n in children and a >= s and b <= e)
    return covered / total


@pytest.mark.cuda
def test_kkt_child_spans_cover_their_parents_on_card(warm_call_on_card):
    ranges = warm_call_on_card["ranges"]
    assert _covered(ranges, "kkt.prepare", {
        "oracle.gather", "oracle.hessian", "oracle.jacobian"}) >= 0.9
    assert _covered(ranges, "kkt.solve", {
        "kkt.condense", "kkt.assemble", "kkt.bbd_solve",
        "kkt.expand"}) >= 0.9


# -- the point evaluations' CUDA graphs (solver/_graphs.py) ------------------

def _graph_counts(group="oracle_graph"):
    from dompc_tpu_torch.tools import profiler
    c = getattr(profiler, group)
    return np.array([c.captures, c.replays, c.eager, c.failures])


@pytest.fixture(scope="module")
def cstr_f32_on_card():
    """The robust CSTR (N = 20) in float32 on the card, B = 256 of bench.py's
    states, with the batched entry's parameter vectors."""
    from dompc_tpu_torch.systems import bench_states, cstr_robust_mpc
    _needs_card()
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, x64=False)
        mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    x0s = bench_states(256)
    pvec = torch.as_tensor(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)),
                           dtype=mpc._dtype, device=mpc._device)
    pvec = pvec.expand(len(x0s), -1).clone()
    pvec[:, mpc._p_sl["x0"]] = torch.as_tensor(x0s, dtype=mpc._dtype,
                                               device=mpc._device)
    return mpc, x0s, pvec


def _solver(mpc):
    from dompc_tpu_torch.parallel import make_batch_solver
    return make_batch_solver(mpc, tol=1e-3, max_iter=60,
                             throughput_mode=True)


@pytest.mark.cuda
def test_point_evaluations_replay_equal_eager_on_card(cstr_f32_on_card):
    """Each point evaluation of the IPM, replayed as a graph at points it
    was not captured at, equals its bare eager evaluation to float32
    roundoff; a key not seen in the solve runs eagerly once, captures at
    its second sight and replays from its third.  The products the
    throughput solve never evaluates are a full-featured solver's (its
    ladder and residual checks evaluate them at every Newton step),
    evaluated through the throughput solver's cache."""
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    mpc, x0s, pvec = cstr_f32_on_card
    solve = _solver(mpc)
    sol, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
    assert bool(sol.success.all())
    full = make_batch_solver(mpc, tol=1e-6, max_iter=3)
    full(x0s, sol.w, sol.lam, 1e-4, sol.zl, sol.zu)
    assert full.ipm.newton_steps > 0
    graphs = solve.ipm.graphs
    fns = {key[0].__name__: key[0] for key in full.ipm.graphs._keys}
    fns.update({key[0].__name__: key[0] for key in graphs._keys})
    m = mpc.n_opt_lagr
    gen = torch.Generator(device="cuda").manual_seed(0)
    points = []
    for k in range(4):
        dx = 1e-2 * torch.randn(sol.w.shape, generator=gen, device="cuda",
                                dtype=sol.w.dtype)
        points.append((sol.w * (1 + 1e-3 * k), sol.lam * (1 + 1e-2 * k), dx))
    cases = {
        "point_evals": lambda w, lam, dx: (w, lam, pvec),
        "eval_all": lambda w, lam, dx: (w, pvec),
        "jgT_mv": lambda w, lam, dx: (w, pvec, lam[:, :m]),
        "jg_mv": lambda w, lam, dx: (w, pvec, dx),
        "hvp": lambda w, lam, dx: (w, pvec, lam[:, :m], lam[:, m:], dx),
    }
    for name, args_of in cases.items():
        fn = fns[name + "_"]
        before = _graph_counts()
        for point in points:
            args = args_of(*point)
            got = graphs(fn, args)
            ref = fn(*args)
            got, ref = (got, ref) if isinstance(got, tuple) else \
                ((got,), (ref,))
            for a, b in zip(got, ref):
                if b.numel():
                    err = float((a - b).abs().max())
                    assert err <= 1e-6 * max(float(b.abs().max()), 1e-30), \
                        (name, err)
        captures, replays, eager, failures = _graph_counts() - before
        seen = name in ("point_evals", "eval_all")   # the solve's keys
        assert (captures, replays, eager, failures) == (
            (0, 4, 0, 0) if seen else (1, 2, 1, 0)), name


@pytest.mark.cuda
def test_solves_with_graphs_equal_bare_on_card(cstr_f32_on_card,
                                               monkeypatch):
    """A cold and a warm B = 256 call take the same Newton steps to the
    same KKT errors with the graphs as shipped and with every evaluation
    bare; with the graphs each key of the solve captures once and replays
    after it."""
    from dompc_tpu_torch.parallel import initial_guess_from_x0
    from dompc_tpu_torch.solver import _graphs
    mpc, x0s, _ = cstr_f32_on_card

    def run():
        solve = _solver(mpc)
        before = _graph_counts()
        before_prep = _graph_counts("prepare_graph")
        cold, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
        steps_cold = solve.ipm.newton_steps
        warm, _ = solve(x0s * 1.001, cold.w, cold.lam, 1e-4, cold.zl,
                        cold.zu)
        return (cold, warm, steps_cold, solve.ipm.newton_steps - steps_cold,
                _graph_counts() - before, solve.ipm.graphs,
                _graph_counts("prepare_graph") - before_prep)

    shipped = run()
    monkeypatch.setattr(_graphs.GraphCache, "_eligible",
                        lambda self, args: False)
    bare = run()
    assert shipped[2:4] == bare[2:4] and shipped[2] > 1
    for a, b in zip(shipped[:2], bare[:2]):
        assert bool(a.success.all()) and bool(b.success.all())
        assert torch.equal(a.iterations, b.iterations)
        assert float((a.kkt_err - b.kkt_err).abs().max()) <= 1e-6
    captures, replays, eager, failures = shipped[4]
    prep = shipped[6]      # the gather, Hessian and Jacobian keys
    states = list(shipped[5]._keys.values())
    graphs = [s for s in states if isinstance(s, _graphs._Graph)]
    assert failures == 0 and captures >= 3
    assert len(graphs) == len(states) == captures + prep[0]
    assert replays > 10 * captures
    assert tuple(prep) == (3, 3 * (shipped[2] + shipped[3] - 2), 3, 0)
    assert tuple(bare[4][:2]) == (0, 0) and bare[4][3] == 0
    assert tuple(bare[6][:2]) == (0, 0) and bare[6][3] == 0


def _prepare_replays_equal_eager(mpc, sol, pvec, rel):
    """prepare's instance derivatives ``Hi``, ``Jg_i``, ``Jh_i`` at four
    points near ``sol``: eager at the first, captured at the second,
    replayed at the last two, each within ``rel`` (relative to the
    tensor's largest entry) of the bare evaluation; the solver's own
    point-evaluation counters do not move."""
    from dompc_tpu_torch.solver._graphs import GraphCache
    bare_cache = GraphCache()
    bare_cache._eligible = lambda args: False
    prepare, _ = mpc._make_kkt_backend("condensed", 1e-8, 1, GraphCache())
    bare, _ = mpc._make_kkt_backend("condensed", 1e-8, 1, bare_cache)
    m = mpc.n_opt_lagr
    sig = torch.ones_like(sol.w)
    inv_sig_s = torch.ones((sol.w.shape[0], mpc._n_ineq),
                           dtype=sol.w.dtype, device=sol.w.device)
    points = [(sol.w * (1 + 1e-3 * k), sol.lam * (1 + 1e-2 * k))
              for k in range(4)]
    args = [(w, pvec, lam[:, :m], lam[:, m:], sig, inv_sig_s)
            for w, lam in points]
    wants = [bare(*a) for a in args]
    before = _graph_counts("prepare_graph")
    before_point = _graph_counts()
    gots = [prepare(*a) for a in args]
    counts = _graph_counts("prepare_graph") - before
    worst = 0.0
    for got, want in zip(gots, wants):
        for a, b in zip(got[:3], want[:3]):
            assert a.shape == b.shape and a.dtype == b.dtype
            if b.numel():
                err = float((a - b).abs().max()) \
                    / max(float(b.abs().max()), 1e-300)
                worst = max(worst, err)
    assert worst <= rel, worst
    assert tuple(counts) == (3, 6, 3, 0)
    assert not (_graph_counts() - before_point).any()
    return worst


@pytest.mark.cuda
def test_prepare_oracles_replay_equal_eager_on_card(cstr_f32_on_card):
    """The robust CSTR in float32 at B = 256: the replayed instance
    Hessians and Jacobians equal the eager ones to 1e-6 relative."""
    from dompc_tpu_torch.parallel import initial_guess_from_x0
    mpc, x0s, pvec = cstr_f32_on_card
    sol, _ = _solver(mpc)(x0s, initial_guess_from_x0(mpc, x0s))
    assert bool(sol.success.all())
    print(f"cstr f32 prepare replay vs eager: "
          f"{_prepare_replays_equal_eager(mpc, sol, pvec, 1e-6):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("host_op", ["item", "pageable_copy"])
def test_failed_capture_stays_eager_on_card(host_op):
    """An evaluation that reads the card from the host, or copies a host
    value in, cannot be captured: its key counts one failure and runs
    eagerly for good, equal to the bare evaluation, and another key of the
    same cache still captures and replays equal to its own."""
    from dompc_tpu_torch.solver._graphs import GraphCache
    _needs_card()

    def host_bound(x, y):
        if host_op == "item":
            scale = float(x.abs().max().item())
        else:
            scale = torch.tensor(2.0, dtype=x.dtype, device=x.device)
        return x * scale + y

    def pure(x, y):
        return x * y, (x + y).sum(-1)

    gen = torch.Generator(device="cuda").manual_seed(1)
    y = torch.randn((256, 64), generator=gen, device="cuda")
    xs = [torch.randn((256, 64), generator=gen, device="cuda")
          for _ in range(4)]
    cache = GraphCache()
    before = _graph_counts()
    outs = [cache(host_bound, (x, y)) for x in xs]
    assert tuple(_graph_counts() - before) == (0, 0, 4, 1)
    for x, out in zip(xs, outs):
        assert torch.equal(out, host_bound(x, y))
    before = _graph_counts()
    outs = [cache(pure, (x, y)) for x in xs]
    assert tuple(_graph_counts() - before) == (1, 2, 1, 0)
    for x, out in zip(xs, outs):
        for a, b in zip(out, pure(x, y)):
            assert torch.equal(a, b)
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dynamic_bounds_calls_replay_on_card():
    """Branch-and-bound's calls with per-node bounds are calls of one
    solver, through its one cache: the later calls capture nothing, and
    every call answers as bare evaluations do."""
    from dompc_tpu_torch.solver import _graphs
    from dompc_tpu_torch.solver.ipm import IPMSettings, make_ipm_solver
    _needs_card()

    def build():
        return make_ipm_solver(
            lambda w, p: ((w - p) ** 2).sum(-1),
            lambda w, p: w[:, :1] + w[:, 1:2] - 1.0,
            lambda w, p: w[:, :1] ** 2 - 4.0,
            np.full(2, -10.0), np.full(2, 10.0), 1, 1,
            settings=IPMSettings(tol=1e-8), dynamic_bounds=True,
            dtype=torch.float64, device="cuda")

    def T(a):
        return torch.tensor(a, dtype=torch.float64, device="cuda")
    w0, p = T(np.zeros((3, 2))), T([[0.0, 0.0], [1.0, 2.0], [3.0, -1.0]])
    bounds = [(T(np.full((3, 2), -10.0 + k)), T(np.full((3, 2), 10.0 - j)))
              for k, j in ((0.0, 0.0), (9.5, 8.5), (0.0, 9.0))]
    solve, deltas, got = build(), [], []
    for lb, ub in bounds:
        before = _graph_counts()
        got.append(solve(w0, p, lb_dyn=lb, ub_dyn=ub))
        deltas.append(_graph_counts() - before)
    assert deltas[0][0] > 3 and deltas[1][0] == deltas[2][0] == 0
    assert all(d[3] == 0 for d in deltas) and deltas[2][1] > 10
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_graphs.GraphCache, "_eligible", lambda self, args: False)
        bare = build()
        want = [bare(w0, p, lb_dyn=lb, ub_dyn=ub) for lb, ub in bounds]
    for a, b in zip(got, want):
        assert bool(a.success.all()) and torch.equal(a.iterations,
                                                     b.iterations)
        assert float((a.w - b.w).abs().max()) <= 1e-12


# -- the polymerization reactor in float64 through the batched entry ----------

def _poly_states(B, seed=0):
    """B reactor states around examples/industrial_poly/main.py's initial
    state (2 % spread on the masses and accum_monom, 0.2 % on the
    temperatures, T_R kept 1.5 K inside its bounds), T_adiab completed
    from (m_W, m_A, m_P, T_R) as main.py does."""
    from dompc_tpu_torch.systems import industrial_poly_x0
    x0 = industrial_poly_x0()
    rel = np.array([0.02, 0.02, 0.02] + [0.002] * 5 + [0.02, 0.0])
    rng = np.random.default_rng(seed)
    x0s = x0 * (1.0 + rel * rng.standard_normal((B, x0.size)))
    x0s[:, 3] = np.clip(x0s[:, 3], 361.65, 364.65)
    m_W, m_A, m_P, T_R = x0s[:, :4].T
    x0s[:, 9] = m_A * 950.0 / ((m_W + m_A + m_P) * 5.0) + T_R
    return x0s


def _poly_mpc(monkeypatch, platform=None):
    from dompc_tpu_torch.systems import (industrial_poly_model,
                                         industrial_poly_mpc)
    _port_env(monkeypatch, platform=platform, x64=True)
    return industrial_poly_mpc(industrial_poly_model(), n_horizon=20,
                               n_robust=1)


@pytest.mark.cuda
def test_poly_f64_batch_certifies_and_refines_on_card(monkeypatch):
    """A float64 B = 8 cold call of the polymerization (N = 20, tol 1e-3,
    throughput mode) certifies every instance with finite u0 inside the
    input bounds; each Newton step's KKT solves take one refinement pass,
    and the ``kkt.refine`` spans equal ``bbd_solve.refine_passes``; no
    point evaluation or derivative oracle fails to capture."""
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    from dompc_tpu_torch.solver.bbd import bbd_solve
    _needs_card()
    mpc = _poly_mpc(monkeypatch)
    assert mpc._dtype == torch.float64 and mpc._device.type == "cuda"
    solve = make_batch_solver(mpc, tol=1e-3, max_iter=100,
                              throughput_mode=True)
    x0s = _poly_states(8)
    before, passes0 = _graph_counts(), bbd_solve.refine_passes
    before_prep = _graph_counts("prepare_graph")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sol, u0 = solve(x0s, initial_guess_from_x0(mpc, x0s))
        torch.cuda.synchronize()
    passes = bbd_solve.refine_passes - passes0
    ranges, _ = _kineto(prof)
    names = [r[0] for r in ranges]
    assert bool(sol.success.all()), sol.iterations.tolist()
    u0 = u0.cpu().numpy()
    lo = mpc._lb_opt_x[mpc.layout.sl(("u", 0, 0))] * mpc._u_scaling.data
    hi = mpc._ub_opt_x[mpc.layout.sl(("u", 0, 0))] * mpc._u_scaling.data
    assert np.isfinite(u0).all()
    assert (u0 >= lo - 1e-9 * (1 + abs(lo))).all()
    assert (u0 <= hi + 1e-9 * (1 + abs(hi))).all()
    assert passes >= solve.ipm.newton_steps > 0
    assert names.count("kkt.refine") == passes
    assert names.count("kkt.refine") == names.count("kkt.bbd_solve")
    assert (_graph_counts() - before)[3] == 0
    assert (_graph_counts("prepare_graph") - before_prep)[3] == 0


@pytest.mark.cuda
def test_poly_f64_three_steps_match_cpu_on_card(monkeypatch):
    """Three Newton steps (``max_iter=3``) of a float64 B = 8 cold call of
    the polymerization on the card reach the CPU port's iterate,
    componentwise over (1 + |w|), within 1e-9: the band kernel and the
    CPU's plain sweep round in other orders and three steps carry the
    difference through the KKT's conditioning (NVIDIA H100: 1.06e-12), so
    the bound leaves a thousand times that, and lies far under the 1e-3 the
    solver's tolerance works at."""
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    _needs_card()
    x0s = _poly_states(8, seed=1)
    out = {}
    for platform in ("cuda", "cpu"):
        mpc = _poly_mpc(monkeypatch,
                        platform="cpu" if platform == "cpu" else None)
        assert mpc._device.type == platform
        solve = make_batch_solver(mpc, tol=1e-3, max_iter=3,
                                  throughput_mode=True)
        sol, _ = solve(x0s, initial_guess_from_x0(mpc, x0s))
        out[platform] = (sol.w.cpu(), sol.iterations.cpu())
    (w_gpu, it_gpu), (w_cpu, it_cpu) = out["cuda"], out["cpu"]
    assert torch.equal(it_gpu, it_cpu) and int(it_gpu.max()) == 3
    gap = float(((w_gpu - w_cpu).abs() / (1 + w_cpu.abs())).max())
    print(f"poly f64 3 steps: card vs CPU {gap:.3e}")
    assert gap <= 1e-9, gap


@pytest.mark.cuda
def test_poly_f64_prepare_oracles_replay_equal_eager_on_card(monkeypatch):
    """The polymerization in float64 at B = 8, at the iterate of three
    Newton steps: the replayed instance Hessians and Jacobians equal the
    eager ones to 1e-12 relative."""
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    _needs_card()
    mpc = _poly_mpc(monkeypatch)
    x0s = _poly_states(8, seed=2)
    sol, _ = make_batch_solver(mpc, tol=1e-3, max_iter=3,
                               throughput_mode=True)(
        x0s, initial_guess_from_x0(mpc, x0s))
    pvec = torch.as_tensor(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)),
                           dtype=mpc._dtype, device=mpc._device)
    pvec = pvec.expand(len(x0s), -1).clone()
    pvec[:, mpc._p_sl["x0"]] = torch.as_tensor(x0s, dtype=mpc._dtype,
                                               device=mpc._device)
    print(f"poly f64 prepare replay vs eager: "
          f"{_prepare_replays_equal_eager(mpc, sol, pvec, 1e-12):.3e}")
