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


def test_scatter_sum_cols_matches_index_add():
    """The KKT assembly's scatter (repeated indices summed in a fixed
    order) gives index_add's sums."""
    from dompc_tpu_torch.solver.bbd import scatter_sum_cols
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 7, 40))
    src = torch.as_tensor(rng.standard_normal((3, 40)))
    ref = torch.zeros((3, 9), dtype=src.dtype).index_add(1, idx, src)
    assert torch.allclose(scatter_sum_cols(idx, src, 9), ref, rtol=0,
                          atol=1e-14)


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
    """The tiled kernel's launch layout follows registers, not shared
    memory: at the flagship a lane owns 2 of the 51 panel columns (width
    64), one warp solves a chain, and G = 4 warps a block; its
    __launch_bounds__(128, 3) lets 3 such blocks share an SM, so every one
    of a batch of 128 flagship problems (1152 chains, 9 an SM on 132 SMs)
    is resident in one wave, and 3 blocks' shared memory (2 reflector
    slots of 28 words, 2 staging buffers of 13 x 64 and an x ring of 3 x
    12 right-hand sides at stride 20: 2440 words a warp) fits an SM's
    228 KB.  S no longer matters: the factors live in device memory."""
    plan = band_qr.tiled_plan(13, 12)
    assert plan == band_qr.Plan(rows=13, width=64, chunk=12, chunks=1,
                                buffers=2, G=4, smem=4 * 4 * 2440)
    assert band_qr.TILED_MIN_BLOCKS * plan.G * 132 >= 9 * 128
    assert band_qr.TILED_MIN_BLOCKS * plan.smem <= 228 * 1024
    assert band_qr.tiled_plan(13, 12, chains_per_tile=2).G == 2
    for bad in (0, band_qr.TILED_MAX_G + 1):
        with pytest.raises(ValueError):
            band_qr.tiled_plan(13, 12, chains_per_tile=bad)


@pytest.mark.parametrize("b,t,rows,width,chunk,chunks", [
    (13, 12, 13, 64, 12, 1),      # the flagship: 51 columns, 2 a lane
    (13, 25, 13, 64, 25, 1),      # 3b + t = 64: the last unchunked width
    (13, 26, 13, 64, 13, 2),      # 3b + t = 65: two chunks of 13
    (5, 49, 8, 64, 49, 1), (5, 50, 8, 64, 25, 2),   # 3b + t = 64 | 65
    (14, 12, 16, 64, 12, 1),      # b past the flagship bucket
    (4, 3, 4, 32, 3, 1), (5, 3, 8, 64, 3, 1)])
def test_tiled_plan_buckets_and_chunks(b, t, rows, width, chunk, chunks):
    """Row bucket and right-hand-side chunks on both sides of their edges
    (a lane of bucket r owns ceil((3r + 16) / 32) columns)."""
    plan = band_qr.tiled_plan(b, t)
    assert (plan.rows, plan.width, plan.chunk, plan.chunks) == \
        (rows, width, chunk, chunks)
    assert 3 * b + plan.chunk <= plan.width


@pytest.mark.parametrize("dtype,smem", [(torch.float32, 4 * 2440),
                                        (torch.float64, 8 * 2440)])
def test_qr_plan_flagship(dtype, smem):
    """band_qr at the flagship: one block of 64 threads (51 columns, one a
    thread), the 13-row bucket, one chunk, two staging buffers; 2440 words
    of shared memory (as the tiled kernel's warp)."""
    assert band_qr.qr_plan(13, 12, dtype) == band_qr.Plan(
        rows=13, width=64, chunk=12, chunks=1, buffers=2, G=1, smem=smem)


@pytest.mark.parametrize("b,t,dtype,rows,width,chunks,buffers", [
    (13, 217, torch.float32, 13, 256, 1, 2),   # 3b + t = 256 threads
    (13, 218, torch.float32, 13, 160, 2, 2),   # 257: two chunks of 109
    (4, 12, torch.float64, 4, 32, 1, 2), (5, 12, torch.float64, 8, 32, 1, 2),
    (16, 12, torch.float32, 16, 64, 1, 2), (17, 12, torch.float32, 32, 64,
                                              1, 2),
    (97, 1, torch.float32, 97, 320, 1, 1),     # the widest float32 b
    (69, 1, torch.float64, 97, 224, 1, 1),     # the widest float64 b
    (18, 200, torch.float64, 32, 160, 2, 2)])  # split to fit shared memory
def test_qr_plan_buckets_chunks_and_widest(b, t, dtype, rows, width,
                                            chunks, buffers):
    plan = band_qr.qr_plan(b, t, dtype)
    assert (plan.rows, plan.width, plan.chunks, plan.buffers) == \
        (rows, width, chunks, buffers)
    assert 3 * b + plan.chunk <= plan.width <= band_qr.qr_max_threads(rows)
    assert plan.smem <= band_qr.SMEM_MAX


def test_qr_plan_accepts_what_the_one_block_panel_did():
    """Every (b, t) whose (2b, 3b+t) panel fitted one block's shared memory
    (the acceptance rule of the kernel this one replaced) still has a plan,
    in both dtypes; b past the widest bucket is refused."""
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        for b in range(1, 98):
            for t in (1, 2, 3, 12, 50, 200, 1000):
                fits = itemsize * (2 * b * (3 * b + t) + 2 * b + 3 * b * t
                                   + 2) <= band_qr.SMEM_MAX
                if fits:
                    band_qr.qr_plan(b, t, dtype)
    with pytest.raises(ValueError):
        band_qr.qr_plan(98, 1, torch.float32)


def test_ptxas_report_parses_instances():
    qr = "_Z14band_qr_kernelIfLi13EEvPKT_S2_S2_S2_PS0_S3_iiiiii"
    tl = "_Z23band_sweep_tiled_kernelILi97EEvPKfS1_S1_S1_PfS2_xiiiiii"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{qr}' for 'sm_90a'",
        f"ptxas info    : Function properties for {qr}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 114 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{tl}' for 'sm_90a'",
        "    9280 bytes stack frame, 2060 bytes spill stores, 3272 bytes "
        "spill loads",
        "ptxas info    : Used 168 registers"])
    rep = band_qr.ptxas_report(log)
    assert [r["instance"] for r in rep] == ["band_qr<float,13>",
                                            "band_sweep_tiled<97>"]
    assert (rep[0]["registers"], rep[0]["spill_stores"]) == (114, 0)
    assert (rep[1]["registers"], rep[1]["spill_loads"]) == (168, 3272)


def test_band_probe_patches_the_committed_core():
    """tools/band_probe.py adds its clock reads at anchors of
    csrc/band_core.cuh; they must still be there, once each."""
    from dompc_tpu_torch.tools.band_probe import probe_source
    core = (band_qr._CSRC / "band_core.cuh").read_text()
    probed = probe_source(core)
    assert probed.count("clock64()") == 3
    assert probed.count("band_probe_clk[") == 3


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
