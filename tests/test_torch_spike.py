"""Long chains (S >= 48) in the PyTorch port against the JAX package.

On CPU tensors the port's ``bbd_solve`` sweeps a long chain whole, as the
JAX package's ``"scan"`` choice does (``dompc_tpu/solver/bbd.py:884-885``),
with the float32 refinement bump of its partition heuristic; on the card it
cuts the chain into SPIKE segments (``solver/batchqr.py``), whose plain
version is held here against the JAX package's ``band_solve_spike_impl``.
Float64 to 1e-12 relative (both are Householder-QR sweeps, so they differ
by rounding only); float32 to 1e-5 relative after the two refinement
passes on both sides.  The kernel-SPIKE checks need the card:
``tests/test_torch_cuda.py``.

Bands wider than the kernels' widest row bucket (b > 97) take the plain
sweep on the card, as JAX routes chains past its fit rule: the route is
decided from the shape (:func:`bbd.chain_sweep`, checked here without a
card) and such a chain equals JAX's sweep to 1e-12.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dompc_tpu.solver.bbd import bbd_solve as jax_bbd_solve
from dompc_tpu.solver.bbd import band_solve_qr_multi as jax_band_qr
from dompc_tpu.solver.batchqr import (
    band_solve_spike_impl as jax_spike)
from dompc_tpu_torch.solver import band_qr, batchqr
from dompc_tpu_torch.solver.bbd import (bbd_solve, bbd_matvec, band_matvec,
                                        chain_sweep)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread: test workers running side by side would
    # otherwise each spin a pool over all the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


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


def _chain_case(N, S, b, t, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 2 * b ** 0.5 * np.eye(b)
    U = rng.standard_normal((N, S - 1, b, b))
    Lo = rng.standard_normal((N, S - 1, b, b))
    rhs = rng.standard_normal((N, S, b, t))
    return D, U, Lo, rhs


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("R", [0, 2])
def test_bbd_solve_long_chain_matches_jax(monkeypatch, dtype, tol, R):
    """S=50 on the CPU: the port solves (it raised before) and equals JAX;
    in float32 both sides refine twice (DOMPC_TPU_SPIKE_F32_REFINE)."""
    monkeypatch.delenv("DOMPC_TPU_SPIKE", raising=False)
    monkeypatch.delenv("DOMPC_TPU_SPIKE_F32_REFINE", raising=False)
    monkeypatch.delenv("DOMPC_TPU_BAND_BACKEND", raising=False)
    arrays = _bbd_case(2, 50, 4, R, seed=50 + R)
    xc_j, xr_j = jax_bbd_solve(*[jnp.asarray(a, dtype) for a in arrays])
    targs = [torch.as_tensor(a, dtype=getattr(torch, dtype))
             for a in arrays]
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return band_qr.band_solve_qr_multi(*args)

    monkeypatch.setattr(band_qr, "band_solve", counting)
    xc, xr = bbd_solve(*targs)
    # the whole chain, once, plus two refinement passes in float32
    assert calls == [(2, 50, 4, 4)] * (3 if dtype == "float32" else 1)
    assert _rel(xc.numpy(), xc_j) <= tol
    if R:
        assert _rel(xr.numpy(), xr_j) <= tol
    y_c, _ = bbd_matvec(*targs[:5], xc, xr)
    assert float((y_c - targs[5]).abs().max()) < (1e-4 if dtype == "float32"
                                                  else 1e-12)


@pytest.mark.parametrize("N,S,b,t,P", [(2, 50, 4, 3, 6), (1, 101, 23, 1, 13),
                                       (2, 9, 3, 2, 2), (1, 7, 2, 1, 4)])
def test_spike_plain_matches_jax(N, S, b, t, P):
    """The plain SPIKE against JAX's band_solve_spike_impl (float64):
    (2, 50, 4, 3, P=6) and the DIP's chain (1, 101, 23, 1, P=13); a
    two-segment and a one-stage-segment partition against the unpartitioned
    sweep.  Each launches the two sweeps of the design, at the partition's
    shapes."""
    arrays = _chain_case(N, S, b, t, seed=S + b)
    targs = [torch.as_tensor(a) for a in arrays]
    ref = jax_spike(*[jnp.asarray(a) for a in arrays], P) if S >= 48 \
        else band_qr.band_solve_qr_multi(*targs).numpy()
    shapes = []

    def recording(D, U, Lo, rhs):
        shapes.append(tuple(rhs.shape))
        assert all(a.is_contiguous() for a in (D, U, Lo, rhs))
        return band_qr.band_solve_qr_multi(D, U, Lo, rhs)

    got = batchqr.band_solve_spike_impl(*targs, P, sweep=recording)
    assert _rel(got.numpy(), ref) <= 1e-12
    L = -(-(S - (P - 1)) // P)
    assert shapes == [(N * P, L, b, 2 * b + t), (N, P - 1, b, t)]
    resid = band_matvec(*targs[:3], got) - targs[3]
    assert float(resid.abs().max()) < 1e-10


def test_spike_default_sweep_and_degenerate_partition(monkeypatch):
    """The default sweep is band_qr.band_solve, looked up at the call (so a
    recorder bound over it sees both sweeps); a partition too fine for the
    chain takes one plain sweep."""
    arrays = [torch.as_tensor(a) for a in _chain_case(1, 9, 3, 1, seed=3)]
    calls = []

    def counting(*args):
        calls.append(args[3].shape)
        return band_qr.band_solve_qr_multi(*args)

    monkeypatch.setattr(band_qr, "band_solve", counting)
    ref = band_qr.band_solve_qr_multi(*arrays)
    got = batchqr.band_solve_spike_impl(*arrays, 3)
    assert len(calls) == 2 and _rel(got.numpy(), ref.numpy()) < 1e-12
    calls.clear()
    got = batchqr.band_solve_spike_impl(*arrays, 6)     # S < 2P - 1
    assert calls == [(1, 9, 3, 1)]
    assert torch.equal(got, ref)


def test_wide_band_chain_matches_jax():
    """A (2, 6, 100, 2) chain (b = 100, past row bucket 97): the port's
    sweep and ``bbd_solve`` (one border column) equal JAX's
    ``band_solve_qr_multi`` and ``bbd_solve`` in float64."""
    import jax
    D, U, Lo, rhs = _chain_case(2, 6, 100, 2, seed=100)
    ref = np.asarray(jax.vmap(jax_band_qr)(*[jnp.asarray(a)
                                             for a in (D, U, Lo, rhs)]))
    got = band_qr.band_solve(*[torch.as_tensor(a) for a in (D, U, Lo, rhs)])
    assert _rel(got.numpy(), ref) <= 1e-12
    arrays = _bbd_case(2, 6, 100, 1, seed=101)
    xc_j, xr_j = jax_bbd_solve(*[jnp.asarray(a) for a in arrays])
    xc, xr = bbd_solve(*[torch.as_tensor(a) for a in arrays])
    assert _rel(xc.numpy(), xc_j) <= 1e-12
    assert _rel(xr.numpy(), xr_j) <= 1e-12


def test_chain_sweep_routes_wide_bands_past_the_kernels():
    """The route is decided from the shape, before any launch: on the card
    b <= 97 takes the kernels (tiled before SPIKE), b > 97 the plain sweep,
    whole or inside SPIKE; on the CPU every band takes band_solve (its
    plain version there), as before."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert chain_sweep(97, cuda, "pallas", 0) == (band_qr.band_solve, False)
    assert chain_sweep(97, cuda, "pallas_tiled", 0) == (
        band_qr.band_solve_tiled, False)
    assert chain_sweep(98, cuda, "pallas", 0) == (
        band_qr.band_solve_qr_multi, True)
    assert chain_sweep(98, cuda, "pallas_tiled", 0) == (
        band_qr.band_solve_qr_multi, True)
    assert chain_sweep(98, cpu, "pallas", 0) == (band_qr.band_solve, False)
    assert chain_sweep(98, cpu, "pallas", 6) == (band_qr.band_solve, False)
    # a partitioned wide chain: SPIKE over the plain sweep
    sweep, plain = chain_sweep(98, cuda, "pallas", 6)
    assert plain
    arrays = [torch.as_tensor(a) for a in _chain_case(1, 50, 3, 2, seed=9)]
    assert _rel(sweep(*arrays).numpy(),
                band_qr.band_solve_qr_multi(*arrays).numpy()) < 1e-12
