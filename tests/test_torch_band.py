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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread: test workers running side by side would
    # otherwise each spin a pool over all the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """Chains of S >= 48 stages were refused on the CPU before SPIKE was
    ported; now the CPU sweeps them whole, as JAX's "scan" choice does
    (tests/test_torch_spike.py holds them against JAX at S=50)."""
    arrays = _bbd_case(1, 48, 2, 1, seed=1)
    targs = _torch(arrays, torch.float64)
    xc, xr = bbd_solve(*targs)
    y_c, y_r = bbd_matvec(*targs[:5], xc, xr)
    assert float((y_c - targs[5]).abs().max()) < 1e-12
    assert float((y_r - targs[6]).abs().max()) < 1e-12


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
    """The tiled kernel's launch layout, by row bucket.  Up to bucket 16 it
    follows registers, not shared memory: at the flagship a lane owns 2 of
    the 51 panel columns (width 64), one warp solves a chain, and G = 4
    warps a block; its __launch_bounds__(128, 3) lets 3 such blocks share
    an SM, so every one of a batch of 128 flagship problems (1152 chains, 9
    an SM on 132 SMs) is resident in one wave, and 3 blocks' shared memory
    (2 reflector slots of 28 words, 2 staging buffers of 13 x 64 and an x
    ring of 3 x 12 right-hand sides at stride 20: 2440 words a warp) fits
    an SM's 228 KB.  S no longer matters: the factors live in device
    memory.  At bucket 32 a chain takes band_qr's block of 3b + t threads
    rounded up to 32 (at most 256), one chain a block; at buckets 64 and 97
    band_qr_wide's plan, one block of 512 a chain."""
    plan = band_qr.tiled_plan(13, 12)
    assert plan == band_qr.Plan(rows=13, width=64, chunk=12, chunks=1,
                                buffers=2, G=4, smem=4 * 4 * 2440)
    assert band_qr.TILED_MIN_BLOCKS * plan.G * 132 >= 9 * 128
    assert band_qr.TILED_MIN_BLOCKS * plan.smem <= 228 * 1024
    assert band_qr.tiled_plan(13, 12, chains_per_tile=2).G == 2
    for bad in (0, band_qr.TILED_MAX_G + 1):
        with pytest.raises(ValueError):
            band_qr.tiled_plan(13, 12, chains_per_tile=bad)
    # bucket 32: the DIP's chain (b = 23, t = 1), 3 warps a chain
    dip = band_qr.tiled_plan(23, 1)
    assert dip == band_qr.qr_plan(23, 1, torch.float32)
    assert (dip.rows, dip.width, dip.G) == (32, 96, 1)
    assert band_qr.tiled_plan(23, 1, chains_per_tile=1) == dip
    for b, t in ((17, 1), (23, 1), (32, 1), (17, 205)):
        plan = band_qr.tiled_plan(b, t, chains_per_tile=1)
        assert plan.G == 1 and plan.width <= 256
        assert plan.smem <= band_qr.SMEM_MAX
        with pytest.raises(ValueError):
            band_qr.tiled_plan(b, t, chains_per_tile=2)
    # buckets 64 and 97: the MHE's band (b = 83, t = 2)
    mhe = band_qr.tiled_plan(83, 2)
    assert mhe == band_qr.wide_plan(83, 2, torch.float32)
    assert band_qr.tiled_plan(83, 2, chains_per_tile=1) == mhe
    for b in (33, 83, 97):
        with pytest.raises(ValueError):
            band_qr.tiled_plan(b, 2, chains_per_tile=2)


@pytest.mark.parametrize("b,t,rows,width,chunk,chunks", [
    (13, 12, 13, 64, 12, 1),      # the flagship: 51 columns, 2 a lane
    (13, 25, 13, 64, 25, 1),      # 3b + t = 64: the last unchunked width
    (13, 26, 13, 64, 13, 2),      # 3b + t = 65: two chunks of 13
    (5, 49, 8, 64, 49, 1), (5, 50, 8, 64, 25, 2),   # 3b + t = 64 | 65
    (14, 12, 16, 64, 12, 1),      # b past the flagship bucket
    (4, 3, 4, 32, 3, 1), (5, 3, 8, 64, 3, 1),
    (16, 16, 16, 64, 16, 1), (16, 17, 16, 64, 9, 2),   # 3b + t = 64 | 65
    # bucket 32 (b = 17..32): 3b + t threads rounded up to 32 a chain, at
    # most 256 (3b + t = 64 | 65, 256 | 257)
    (17, 1, 32, 64, 1, 1), (17, 13, 32, 64, 13, 1), (17, 14, 32, 96, 14, 1),
    (17, 205, 32, 256, 205, 1), (17, 206, 32, 160, 103, 2),
    (32, 1, 32, 128, 1, 1), (32, 160, 32, 256, 160, 1),
    (32, 161, 32, 192, 81, 2),
    # buckets 64 and 97 (b = 33..97): 512 threads, one chunk at any t
    (33, 2, 64, 512, 2, 1), (33, 1000, 64, 512, 1000, 1),
    (64, 2, 64, 512, 2, 1), (65, 2, 97, 512, 2, 1), (97, 1, 97, 512, 1, 1),
    (97, 168, 97, 512, 168, 1)])
def test_tiled_plan_buckets_and_chunks(b, t, rows, width, chunk, chunks):
    """Row bucket and right-hand-side chunks on both sides of their edges
    (a lane of bucket r <= 16 owns ceil((3r + 16) / 32) columns; a thread
    of bucket 32 one; the wide buckets stream every column)."""
    plan = band_qr.tiled_plan(b, t)
    assert (plan.rows, plan.width, plan.chunk, plan.chunks) == \
        (rows, width, chunk, chunks)
    if rows > band_qr.NARROW_MAX:
        assert plan.width == band_qr.WIDE_THREADS and plan.G == 1
    else:
        assert 3 * b + plan.chunk <= plan.width
    assert plan.smem <= band_qr.SMEM_MAX


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
    (97, 1, torch.float32, 97, 512, 1, 2),     # band_qr_wide's widest b:
    (69, 1, torch.float64, 97, 512, 1, 2),     # 512 threads, one chunk
    (18, 200, torch.float64, 32, 160, 2, 2),   # split to fit shared memory
    (23, 47, torch.float32, 32, 128, 1, 2),    # the DIP's SPIKE segments:
    (23, 47, torch.float64, 32, 128, 1, 2),    # 2b + t columns, one chunk
    (23, 1, torch.float64, 32, 96, 1, 2)])     # its chain and reduced system
def test_qr_plan_buckets_chunks_and_widest(b, t, dtype, rows, width,
                                            chunks, buffers):
    plan = band_qr.qr_plan(b, t, dtype)
    assert (plan.rows, plan.width, plan.chunks, plan.buffers) == \
        (rows, width, chunks, buffers)
    if rows > band_qr.NARROW_MAX:
        assert plan.width == band_qr.WIDE_THREADS and plan.chunk == t
    else:
        assert 3 * b + plan.chunk <= plan.width <= \
            band_qr.qr_max_threads(rows)
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


def _wy_model(D, U, Lo, rhs, nt=32):
    """A torch model of csrc/band_qr_wide.cu's arithmetic: per elimination
    the scaled Householder reflectors of the (m, b) panel (stored as V,
    beta, and R's diagonal alpha * max|x|), T by doubling from G = V'V
    (sibling blocks A, B: T_AB = -T_AA G_AB T_BB), then the trailing
    columns [Uhat 0 rhat; D U r] in tiles of nt as W = V'C, W = T'W,
    C -= V W; the top rows are [R | B | C | c], the bottom rows the carry.
    Back substitution with the |d| > 1e-30 guard as a multiplication by
    1 / d."""
    N, S, b, t = rhs.shape
    dt = rhs.dtype
    F = []
    top = (D[:, 0], U[:, 0] if S > 1 else None, rhs[:, 0])
    for e in range(S):
        last = e == S - 1
        Dh, Uh, rh = top
        if last:
            Pn, Cn = Dh.clone(), rh.clone()
        else:
            Pn = torch.cat([Dh, Lo[:, e]], dim=1)
            zero = D.new_zeros((N, b, b))
            U_n = U[:, e + 1] if e + 1 < S - 1 else zero
            Cn = torch.cat([torch.cat([Uh, zero, rh], dim=2),
                            torch.cat([D[:, e + 1], U_n, rhs[:, e + 1]],
                                      dim=2)], dim=1)
        m = Pn.shape[1]
        rows = torch.arange(m)
        V = Pn.new_zeros((N, m, b))
        beta = Pn.new_zeros((N, b))
        rdiag = Pn.new_zeros((N, b))
        for p in range(b):
            x = torch.where(rows >= p, Pn[:, :, p], 0.0)
            amax = x.abs().amax(dim=1)
            inv = torch.where(amax > 0, 1 / amax, 0.0)
            v = x * inv[:, None]
            sigma = (v * v).sum(dim=1)
            xp = v[:, p]
            alpha = -torch.where(xp >= 0, 1.0, -1.0) * sigma.sqrt()
            vtv = sigma - xp * xp + (xp - alpha) ** 2
            beta[:, p] = torch.where(vtv > 1e-30, 2 / vtv, 0.0)
            v[:, p] = xp - alpha
            V[:, :, p] = v
            rdiag[:, p] = alpha * amax
            w = torch.einsum("nr,nrc->nc", v, Pn[:, :, p + 1:])
            Pn[:, :, p + 1:] -= (beta[:, p, None] * w)[:, None, :] \
                * v[:, :, None]
        R = torch.triu(Pn[:, :b], 1) + torch.diag_embed(rdiag)
        G = V.transpose(1, 2) @ V
        T = torch.diag_embed(beta)
        w = 1                           # T by doubling, as the kernel
        while w < b:
            for a in range(0, b - w, 2 * w):
                A, B = slice(a, a + w), slice(a + w, min(a + 2 * w, b))
                T[:, A, B] = -T[:, A, A] @ (G[:, A, B] @ T[:, B, B])
            w *= 2
        for c0 in range(0, Cn.shape[2], nt):
            C = Cn[:, :, c0:c0 + nt]
            W = V.transpose(1, 2) @ C
            W = T.transpose(1, 2) @ W
            Cn[:, :, c0:c0 + nt] = C - V @ W
        if last:
            F.append((R, None, None, Cn[:, :b]))
        else:
            F.append((R, Cn[:, :b, :b], Cn[:, :b, b:2 * b], Cn[:, :b, 2 * b:]))
            top = (Cn[:, b:, :b], Cn[:, b:, b:2 * b], Cn[:, b:, 2 * b:])
    xs = [None] * S
    for k in range(S - 1, -1, -1):
        R, B, C, c = F[k]
        y = c.clone()
        if k + 1 < S:
            y -= B @ xs[k + 1]
        if k + 2 < S:
            y -= C @ xs[k + 2]
        d = torch.diagonal(R, dim1=1, dim2=2)
        dinv = 1 / torch.where(d.abs() > 1e-30, d, torch.full_like(d, 1e-30))
        x = torch.zeros_like(y)
        for i in range(b - 1, -1, -1):
            x[:, i] = (y[:, i] - (R[:, i, i + 1:, None] * x[:, i + 1:])
                       .sum(dim=1)) * dinv[:, i, None]
        xs[k] = x
    return torch.stack(xs, dim=1).to(dt)


@pytest.mark.parametrize("shape,nt", [((2, 11, 83, 2), 32),
                                      ((1, 6, 50, 168), 32),
                                      ((1, 4, 97, 20), 16)])
def test_wide_wy_model_matches_jax_twin_f64(shape, nt):
    """band_qr_wide's blocked-WY elimination, modelled in torch, against
    the JAX package's bbd.band_solve_qr_multi at the rotating-masses MHE's
    band (b=83), a SPIKE-segment-like width (2b + t columns) and the widest
    float64 bucket with its 16-column tiles: float64, 1e-12 relative."""
    arrays = _case(*shape, seed=sum(shape))
    ref = jax.vmap(jax_band_multi)(*[jnp.asarray(a) for a in arrays])
    got = _wy_model(*_torch(arrays, torch.float64), nt=nt)
    assert _rel(got.numpy(), ref) <= 1e-12


def test_wide_wy_model_extreme_scales_f32():
    """The model in float32 at the MHE's band with a 1e22 diagonal entry on
    every stage (tests/test_pallas_band.py:126-147): finite, operator
    residual below 1e-3."""
    D, U, Lo, rhs = _case(1, 11, 83, 2, seed=3)
    D[:, :, 0, 0] = 1e22
    D, U, Lo, rhs = _torch((D, U, Lo, rhs), torch.float32)
    got = _wy_model(D, U, Lo, rhs)
    assert bool(torch.isfinite(got).all())
    assert _resid(D, U, Lo, got, rhs) < 1e-3


def _wide_words(b, nt, nbuf, itemsize):
    """csrc/band_qr_wide.cu:plan_words, written out region by region."""
    quad = lambda n: (n + 3) // 4 * 4                       # noqa: E731
    ldp = next(4 * o for o in range(1, 200, 2) if 4 * o >= 2 * b)
    ldc = nt + 32 // itemsize
    panel = quad(ldp * b)
    vectors = 2 * quad(b)                                   # beta, R's diag
    gram = quad(b * (b - 1) // 2)
    tiles = nbuf * quad(2 * b * ldc) + quad(b * ldc)        # C (xnbuf), W
    return panel + vectors + max(gram, tiles)


def test_wide_plan_mirror():
    """band_qr_wide's plan at every b in 33..97, both dtypes and a range of
    t: 512 threads, one chunk of all t right-hand sides whatever t, row
    bucket 64 or 97, the widest tile of 32, 16, 8 that fits (two buffers
    before one), shared bytes within SMEM_MAX; qr_plan and the kernel
    choice agree."""
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        for b in range(33, 98):
            nt, nbuf = next((n, k) for n in (32, 16, 8) for k in (2, 1)
                            if itemsize * _wide_words(b, n, k, itemsize)
                            <= band_qr.SMEM_MAX)
            for t in (1, 2, 24, 168, 1000):
                plan = band_qr.wide_plan(b, t, dtype)
                assert plan == band_qr.qr_plan(b, t, dtype)
                assert band_qr.qr_kernel(b) == "band_qr_wide"
                assert plan == band_qr.Plan(
                    rows=64 if b <= 64 else 97, width=band_qr.WIDE_THREADS,
                    chunk=t, chunks=1, buffers=nbuf, G=1,
                    smem=itemsize * _wide_words(b, nt, nbuf, itemsize),
                    tile=nt)
                assert plan.smem <= band_qr.SMEM_MAX
    assert band_qr.wide_plan(83, 2, torch.float32)[4:] == (2, 1, 124176, 32)
    assert band_qr.wide_plan(83, 2, torch.float64)[4:] == (1, 1, 187264, 32)
    assert band_qr.wide_plan(97, 2, torch.float64)[4:] == (2, 1, 231296, 16)
    assert band_qr.qr_kernel(32) == "band_qr"
    with pytest.raises(ValueError):
        band_qr.wide_plan(98, 1, torch.float64)


def test_ptxas_report_parses_instances():
    qr = "_Z14band_qr_kernelIfLi13EEvPKT_S2_S2_S2_PS0_S3_iiiiii"
    wd = "_Z19band_qr_wide_kernelIdLi97EEvPKT_S2_S2_S2_PS0_S3_iiiii"
    tl = "_Z23band_sweep_tiled_kernelILi{}EEvPKfS1_S1_S1_PfS2_xiiiiiiii"
    log = [
        f"ptxas info    : Compiling entry function '{qr}' for 'sm_90a'",
        f"ptxas info    : Function properties for {qr}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 114 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{wd}' for 'sm_90a'",
        "ptxas info    : Used 128 registers, 8 bytes smem"]
    for rows in band_qr.ROW_BUCKETS:    # every tiled instance, one design
        log += [       # per bucket (one warp, a group of warps, a block)
            f"ptxas info    : Compiling entry function "
            f"'{tl.format(rows)}' for 'sm_90a'",
            f"    {rows} bytes stack frame, {rows} bytes spill stores, "
            f"{2 * rows} bytes spill loads",
            f"ptxas info    : Used {100 + rows} registers"]
    rep = band_qr.ptxas_report("\n".join(log))
    assert [r["instance"] for r in rep] == [
        "band_qr<float,13>", "band_qr_wide<double,97>"] + [
        f"band_sweep_tiled<{rows}>" for rows in band_qr.ROW_BUCKETS]
    assert (rep[0]["registers"], rep[0]["spill_stores"]) == (114, 0)
    assert (rep[1]["registers"], rep[1]["smem"]) == (128, 8)
    for r, rows in zip(rep[2:], band_qr.ROW_BUCKETS):
        assert (r["registers"], r["spill_stores"], r["spill_loads"]) == \
            (100 + rows, rows, 2 * rows)


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
    backend on the CPU sweeps the chain whole with the same two passes,
    and with the float32 heuristic switched off
    (DOMPC_TPU_SPIKE_F32_REFINE=0) without them."""
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
    xc2, _ = bbd_solve(*targs)
    assert torch.equal(xc2, xc)
    monkeypatch.setenv("DOMPC_TPU_SPIKE_F32_REFINE", "0")
    xc0, _ = bbd_solve(*targs)
    assert _rel(xc0.numpy(), xc.numpy()) < 1e-4
