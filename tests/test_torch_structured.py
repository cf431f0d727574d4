"""``solver/structured.py`` of the PyTorch port against the JAX package's
(CPU, float64).

* ``band_matvec``, ``band_factor`` + ``band_solve`` and ``band_solve_qr`` on
  seeded diagonally dominant bands (S=6, b=5; S=1), to 1e-12;
* ``BlockAssembler`` on a synthetic stage layout (4 stages, overlapping
  two-stage instances, parameter columns, inequality rows): its index maps
  and ``assemble`` / ``pack_rhs`` / ``unpack_sol``, exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dompc_tpu.solver import structured as jst
from dompc_tpu_torch.solver import structured as tst

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _band(S, b, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((S, b, b)) + 3.0 * b * np.eye(b)
    U = rng.standard_normal((S - 1, b, b))
    Lo = rng.standard_normal((S - 1, b, b))
    rhs = rng.standard_normal((S, b))
    return D, U, Lo, rhs


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("S", [6, 1])
def test_band_solves_match_jax(S):
    D, U, Lo, rhs = _band(S, 5, seed=S)
    J = [jnp.asarray(a) for a in (D, U, Lo, rhs)]
    T = [torch.as_tensor(a) for a in (D, U, Lo, rhs)]
    assert _rel(tst.band_matvec(*T), jst.band_matvec(*J)) <= TOL

    lu_j, piv_j = jst.band_factor(*J[:3])
    lu_t, piv_t = tst.band_factor(*T[:3])
    assert _rel(lu_t, lu_j) <= TOL
    np.testing.assert_array_equal(piv_t.numpy() - 1, np.asarray(piv_j))
    x_j = jst.band_solve((lu_j, piv_j), J[1], J[2], J[3])
    x_t = tst.band_solve((lu_t, piv_t), T[1], T[2], T[3])
    assert _rel(x_t, x_j) <= TOL
    assert _rel(tst.band_matvec(*T[:3], x_t), rhs) <= TOL

    assert _rel(tst.band_solve_qr(*T), jst.band_solve_qr(*J)) <= TOL
    assert _rel(tst.band_solve_qr(*T), x_t) <= TOL


def _layout():
    """4 stages of 3 variables, 2 equality rows and 1 inequality row; 3
    instances, instance i spanning stages i and i+1 (6 columns, the last
    of instance 1 a parameter), with the equality rows of stage i+1 and
    the inequality row of stage i."""
    S, nw, ng = 4, 3, 2
    n, m, q = S * nw, S * ng, S
    w_stage = np.repeat(np.arange(S), nw)
    g_stage = np.repeat(np.arange(S), ng)
    h_stage = np.arange(S)
    I = S - 1
    A_all = np.stack([np.arange(i * nw, (i + 2) * nw) for i in range(I)])
    A_all[1, -1] = n + 1                   # a parameter column
    R_g = np.stack([np.arange((i + 1) * ng, (i + 2) * ng) for i in range(I)])
    R_h = np.arange(I)[:, None]
    return dict(w_stage=w_stage, g_stage=g_stage, h_stage=h_stage,
                inst_stage=np.arange(I), A_all=A_all, R_g=R_g, R_h=R_h,
                n=n, m=m, q=q, init_cols=np.array([0, 1]))


def test_block_assembler_matches_jax():
    lay = _layout()
    ja, ta = jst.BlockAssembler(**lay), tst.BlockAssembler(**lay)
    for name in ("h_idx", "jg_idx", "jg_idx_T", "jh_idx", "jh_idx_T",
                 "w_diag_idx", "g_diag_idx", "h_diag_idx", "init_idx",
                 "w_pos", "g_pos", "h_pos", "pad_diag"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name),
                                      err_msg=name)
    assert (ta.S, ta.b, ta.T_size) == (ja.S, ja.b, ja.T_size)

    rng = np.random.default_rng(3)
    I, d = lay["A_all"].shape
    args = (rng.standard_normal((I, d, d)),
            rng.standard_normal((I, lay["R_g"].shape[1], d)),
            rng.standard_normal((I, 1, d)),
            rng.uniform(1.0, 2.0, lay["n"]), -1e-8 * np.ones(lay["m"]),
            -rng.uniform(1.0, 2.0, lay["q"]))
    bands_j = ja.assemble(*(jnp.asarray(a) for a in args))
    bands_t = ta.assemble(*(torch.as_tensor(a) for a in args))
    for got, ref in zip(bands_t, bands_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    r = [rng.standard_normal(k) for k in (lay["n"], lay["m"], lay["q"])]
    rhs_j = ja.pack_rhs(*(jnp.asarray(a) for a in r))
    rhs_t = ta.pack_rhs(*(torch.as_tensor(a) for a in r))
    np.testing.assert_array_equal(rhs_t.numpy(), np.asarray(rhs_j))
    x = rng.standard_normal(rhs_t.shape)
    for got, ref in zip(ta.unpack_sol(torch.as_tensor(x)),
                        ja.unpack_sol(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the assembled system solves: the packed residual's solution unpacks
    # to what solving the band directly gives
    x_t = tst.band_solve_qr(*bands_t, rhs_t)
    assert _rel(tst.band_matvec(*bands_t, x_t), rhs_t.numpy()) <= TOL
