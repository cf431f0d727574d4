"""The JAX package's public names of ``solver/batchqr.py`` and
``bbd.band_solve_qr_multi`` in the port, against their JAX counterparts in
float64 on the CPU, on ``tests/test_band_backends.py``'s shapes and
partitions and to its 1e-10 (all are the same scaled Householder sweep,
scheduled differently); ``qr_solve`` on (24, 24) systems to 1e-12 (LU
against Householder QR on well-conditioned systems)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dompc_tpu.solver import batchqr as jax_batchqr
from dompc_tpu.solver import bbd as jax_bbd
from dompc_tpu_torch.solver import batchqr, bbd


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_band(rng, N, S, b, t):
    """tests/test_band_backends.py:_rand_band's inputs, as numpy."""
    D = rng.standard_normal((N, S, b, b)) + 4 * np.eye(b)
    U = rng.standard_normal((N, max(S - 1, 0), b, b)) * 0.5
    Lo = rng.standard_normal((N, max(S - 1, 0), b, b)) * 0.5
    rhs = rng.standard_normal((N, S, b, t))
    return D, U, Lo, rhs


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref))) / (float(np.max(np.abs(ref)))
                                             + 1.0)


# port name, JAX counterpart (bbd's name solves one chain: vmapped), and
# the shape of tests/test_band_backends.py it is held at: one each, so the
# file stays short (JAX compiles each name at each shape anew, 1-2 s)
NAMES = {"band_solve_qr_lanes": (batchqr.band_solve_qr_lanes,
                                 jax_batchqr.band_solve_qr_lanes,
                                 (4, 21, 13, 12)),
         "band_solve": (batchqr.band_solve, jax_batchqr.band_solve,
                        (3, 7, 5, 2)),
         "band_solve_qr_lanes_wy": (batchqr.band_solve_qr_lanes_wy,
                                    jax_batchqr.band_solve_qr_lanes_wy,
                                    (2, 2, 3, 1)),
         "band_solve_wy": (batchqr.band_solve_wy, jax_batchqr.band_solve_wy,
                           (1, 101, 6, 4)),
         "band_solve_qr_multi": (bbd.band_solve_qr_multi,
                                 jax.vmap(jax_bbd.band_solve_qr_multi),
                                 (4, 21, 13, 12))}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_band_sweep_names_match_jax_f64(name):
    port, ref, shape = NAMES[name]
    arrays = _rand_band(np.random.default_rng(0), *shape)
    ts = [torch.as_tensor(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    x = port(*ts)
    assert x.dtype == torch.float64 and x.shape == ts[3].shape
    assert _rel(x.numpy(), ref(*js)) < 1e-10


@pytest.mark.parametrize("shape,P", [((4, 21, 13, 12), 2),
                                     ((1, 101, 6, 4), 13)])
def test_band_solve_spike_matches_jax_f64(shape, P):
    arrays = _rand_band(np.random.default_rng(1), *shape)
    x = batchqr.band_solve_spike(*[torch.as_tensor(a) for a in arrays],
                                 n_parts=P)
    ref = jax_batchqr.band_solve_spike(*[jnp.asarray(a) for a in arrays],
                                       n_parts=P)
    assert _rel(x.numpy(), ref) < 1e-10


def test_qr_solve_matches_jax_f64():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 24, 24)) + 8 * np.eye(24)
    B = rng.standard_normal((5, 24, 3))
    ref = np.asarray(jax_batchqr.qr_solve(jnp.asarray(A), jnp.asarray(B)))
    for fn in (batchqr.qr_solve, batchqr.qr_solve_batched):
        x = fn(torch.as_tensor(A), torch.as_tensor(B)).numpy()
        assert float(np.max(np.abs(x - ref)) / np.max(np.abs(ref))) < 1e-12
