"""Model layer and transcription of the PyTorch port against the JAX package.

* every op of the ``sym`` tables: the JAX expression's op tree rebuilds into
  a torch closure with the same value (float64, 1e-12);
* the flagship CSTR model's rhs and its Jacobians;
* the robust-CSTR transcription: layout, instance index arrays, bounds and
  the collocation stage residual.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dompc_tpu import sym as jsym
from dompc_tpu.ops.collocation import lagrange_matrices as jax_lagrange
from dompc_tpu_torch import sym as tsym
from dompc_tpu_torch.ops.collocation import lagrange_matrices

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry__ import _build_cstr_mpc  # noqa: E402
from dompc_tpu_torch.systems import cstr_robust_mpc  # noqa: E402

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    # one intra-op thread: test workers running side by side would
    # otherwise each spin a pool over all the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _env(rng):
    return {"_x": {"a": rng.uniform(0.1, 0.9, 4),
                   "b": rng.uniform(0.1, 0.9, 4),
                   "M": rng.uniform(0.1, 0.9, (3, 3)) + 2 * np.eye(3),
                   "c": rng.uniform(0.1, 0.9, 3)}}


def _eval_both(expr_j, env):
    """Evaluate a JAX Sym and the torch closure rebuilt from its tree."""
    env_j = {"_x": {k: jnp.asarray(v) for k, v in env["_x"].items()}}
    env_t = {"_x": {k: torch.as_tensor(v) for k, v in env["_x"].items()},
             tsym.META: (torch.float64, torch.device("cpu"))}
    got = tsym._from_tree(expr_j.tree)(env_t)
    return np.asarray(expr_j(env_j), dtype=float), \
        np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                   dtype=float)


a, b = jsym.var("_x", "a"), jsym.var("_x", "b")
M, c = jsym.var("_x", "M"), jsym.var("_x", "c")
_MATRIX_UNARY = {"transpose", "diag", "trace", "inv", "sum1", "sum2"}
_UNARY_CASES = {name: (M if name in _MATRIX_UNARY else a)
                for name in jsym._UNARY}
_BINARY_CASES = {name: (M, c) if name == "matmul" else
                 ((a > 0.5), (b < 0.5)) if name.startswith("logic") else
                 (a, b) for name in jsym._BINARY}
_NARY_CASES = {"vertcat": (a, b), "horzcat": (M, M),
               "if_else": (a > 0.5, a, b)}


@pytest.mark.parametrize("scheme", ["radau", "legendre"])
@pytest.mark.parametrize("deg", [1, 2, 3, 5])
def test_collocation_matrices_equal_exactly(deg, scheme):
    for got, ref in zip(lagrange_matrices(deg, scheme),
                        jax_lagrange(deg, scheme)):
        np.testing.assert_array_equal(got, ref)


def test_op_tables_cover_the_jax_tables():
    assert set(tsym._UNARY) == set(jsym._UNARY)
    assert set(tsym._BINARY) == set(jsym._BINARY)
    assert set(tsym._NARY) == set(jsym._NARY)


@pytest.mark.parametrize("name", sorted(jsym._UNARY))
def test_unary_op_matches_jnp(name):
    expr = jsym._from_tree(("u", name, _UNARY_CASES[name].tree))
    ref, got = _eval_both(expr, _env(np.random.default_rng(1)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(jsym._BINARY))
def test_binary_op_matches_jnp(name):
    x, y = _BINARY_CASES[name]
    expr = jsym._from_tree(("b", name, x.tree, y.tree))
    ref, got = _eval_both(expr, _env(np.random.default_rng(2)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(jsym._NARY))
def test_nary_op_matches_jnp(name):
    expr = jsym._from_tree(("n", name) + tuple(
        v.tree for v in _NARY_CASES[name]))
    ref, got = _eval_both(expr, _env(np.random.default_rng(3)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_constants_getitem_reshape_pack_match_jnp():
    expr = jsym.vertcat(
        (2.0 * a + np.array([1.0, 2.0, 3.0, 4.0])) ** 2,
        jsym.reshape(M, (9,))[2:5], M.T[0], -b[1:3],
        jsym.pack_var("_x", ["c", "a"], [(3, 1), (4, 1)]))
    ref, got = _eval_both(expr, _env(np.random.default_rng(4)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_port_builds_the_same_tree_and_pickles():
    ta, tb = tsym.var("_x", "a"), tsym.var("_x", "b")
    e_t = tsym.if_else(ta > 0.5, tsym.exp(-ta) * tb, tsym.fmax(ta, 0.3))
    e_j = jsym.if_else(a > 0.5, jsym.exp(-a) * b, jsym.fmax(a, 0.3))
    assert e_t.tree == e_j.tree
    env = {"_x": {"a": torch.tensor([0.2, 0.7]),
                  "b": torch.tensor([1.0, 2.0])}}
    back = pickle.loads(pickle.dumps(e_t))
    assert torch.equal(back(env), e_t(env))
    with pytest.raises(TypeError):
        pickle.dumps(tsym.Sym(lambda env: env["_x"]["a"]))


# --------------------------------------------------------------------------
# flagship model and transcription
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mpcs(_cpu_port):
    return _build_cstr_mpc(n_horizon=10), cstr_robust_mpc(n_horizon=10)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=float))


def test_cstr_rhs_and_jacobians_match(mpcs):
    mj, mt = mpcs
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = np.array([0.8, 0.5, 134.0, 130.0]) * rng.uniform(0.8, 1.2, 4)
        u = np.array([20.0, -1000.0]) * rng.uniform(0.5, 1.5, 2)
        p = rng.uniform(0.9, 1.1, 2)
        args = (x, u, np.zeros(0), np.zeros(0), p, np.zeros(0))
        for fn in ("_rhs_fun", "_A_fun", "_B_fun"):
            ref = np.asarray(getattr(mj.model, fn)(
                *[jnp.asarray(v) for v in args]))
            got = getattr(mt.model, fn)(*[_t(v) for v in args]).numpy()
            np.testing.assert_allclose(got, ref, rtol=TOL,
                                       atol=TOL * np.abs(ref).max())


def test_cstr_layout_and_index_arrays_match(mpcs):
    mj, mt = mpcs
    assert mt.layout.offsets == mj.layout.offsets
    assert mt.layout.sizes == mj.layout.sizes
    assert set(mt._inst_arrays) == set(mj._inst_arrays)
    for key, ref in mj._inst_arrays.items():
        np.testing.assert_array_equal(mt._inst_arrays[key], ref, err_msg=key)
    np.testing.assert_array_equal(mt._A_all, mj._A_all)
    np.testing.assert_array_equal(mt._lb_opt_x, mj._lb_opt_x)
    np.testing.assert_array_equal(mt._ub_opt_x, mj._ub_opt_x)
    np.testing.assert_array_equal(mt.opt_x_scaling, mj.opt_x_scaling)
    for got, ref in zip(mt._chain_assignment(), mj._chain_assignment()):
        np.testing.assert_array_equal(got, ref)
    assert (mt._rows_per_inst, mt._nl_rows_per_inst, mt.n_opt_lagr) == \
        (mj._rows_per_inst, mj._nl_rows_per_inst, mj.n_opt_lagr)
    shift_t, shift_j = mt._build_shift_maps(), mj._build_shift_maps()
    assert set(shift_t) == set(shift_j)
    for key, ref in shift_j.items():
        np.testing.assert_array_equal(shift_t[key], ref, err_msg=key)


def test_cstr_stage_residual_matches(mpcs):
    mj, mt = mpcs
    n_x, n_coll = 4, mj.n_total_coll_points
    rng = np.random.default_rng(8)
    for _ in range(3):
        xk0 = rng.uniform(0.3, 1.5, n_x)
        coll = rng.uniform(0.3, 1.5, n_coll * n_x)
        u = rng.uniform(0.05, 0.5, 2) * np.array([1.0, -1.0])
        p = rng.uniform(0.9, 1.1, 2)
        args = (xk0, coll, u, np.zeros(0), np.zeros(0), p, np.zeros(0))
        ref = np.asarray(mj._stage_g(*[jnp.asarray(v) for v in args]))
        got = mt._stage_g(*[_t(v) for v in args]).numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL,
                                   atol=TOL * np.abs(ref).max())


def test_cstr_stage_ranges_match(mpcs):
    """``OCPLayout.stage_ranges`` on the N=10 flagship layout (one stage past
    the last gives the empty range) and the ``compile_nlp`` no-op."""
    mj, mt = mpcs
    n = max(mj.layout.stage_of.values()) + 2
    ranges = mt.layout.stage_ranges(n)
    assert ranges == mj.layout.stage_ranges(n)
    assert ranges[-1] == (0, 0) and ranges[0][0] == 0
    assert mt.compile_nlp() is None
