"""Sharded serving and data-parallel training of the PyTorch port (CPU,
float64, ``torch.distributed`` over gloo).

* a one-rank process group: ``make_sharded_solver`` (cold and warm) on the
  oscillating masses against the JAX package's ``make_sharded_solver`` on
  the conftest's 8 CPU devices, same states: u0 to 1e-8, equal iterations
  and success counts;
* two port-only worker processes (no JAX imported) joined through
  ``init_distributed``'s environment variables: each rank's gathered u0
  and iterations equal ``make_batch_solver`` on the whole batch (1e-12),
  ``n_ok`` is the global count, an indivisible batch and a mesh of fewer
  ranks than the group raise, and the
  Trainer's ``data_parallel`` training on 2 ranks equals one process's
  (tests/test_trainer_dp.py's flow; losses and weights to 1e-6), a batch
  the world size does not divide training unsharded with one warning;
* ``init_distributed()`` without the variables does nothing.
"""
import inspect
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import dompc_tpu as jdm
import dompc_tpu.systems  # noqa: F401
import dompc_tpu.parallel as jpar
import dompc_tpu_torch as tdm
import dompc_tpu_torch.parallel as tpar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _states():
    rng = np.random.default_rng(0)
    return 0.4 * rng.standard_normal((B, 4))


def test_init_distributed_without_variables(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.init_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        tpar.batch_mesh()


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo process group, destroyed after the module."""
    assert tpar.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_and_solve_arity(one_rank):
    """A mesh spans the whole group (2 ranks of a 1-rank group raise), and
    the solver takes 2 arrays cold and 6 warm."""
    with pytest.raises(ValueError, match="whole process group of 1"):
        tpar.batch_mesh(2)
    mesh = tpar.batch_mesh(1)
    assert mesh.size() == 1
    tmpc = tdm.systems.oscillating_masses_mpc(
        tdm.systems.oscillating_masses_model())
    cold, _ = tpar.make_sharded_solver(tmpc, mesh=mesh)
    warm, _ = tpar.make_sharded_solver(tmpc, mesh=mesh, warm=True)
    x0s = _states()
    w0s = tpar.initial_guess_from_x0(tmpc, x0s)
    with pytest.raises(TypeError, match="takes 2 arrays"):
        cold(x0s, w0s, w0s)
    with pytest.raises(TypeError, match="takes 6 arrays"):
        warm(x0s, w0s)


def test_one_rank_sharded_matches_jax(one_rank):
    assert jax.device_count() == 8       # conftest virtual CPU mesh
    x0s = _states()
    jmpc = jdm.systems.oscillating_masses_mpc(
        jdm.systems.oscillating_masses_model())
    tmpc = tdm.systems.oscillating_masses_mpc(
        tdm.systems.oscillating_masses_model())
    w0s = jpar.initial_guess_from_x0(jmpc, x0s)
    np.testing.assert_array_equal(tpar.initial_guess_from_x0(tmpc, x0s),
                                  w0s)
    kw = dict(tol=1e-6, throughput_mode=True)
    j_cold, _ = jpar.make_sharded_solver(jmpc, **kw)
    j_warm, _ = jpar.make_sharded_solver(jmpc, warm=True, **kw)
    t_cold, mesh = tpar.make_sharded_solver(tmpc, **kw)
    t_warm, _ = tpar.make_sharded_solver(tmpc, mesh=mesh, warm=True, **kw)
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("batch",)

    # warm starts: the JAX package's batched cold solution, in both
    sol, _ = jpar.make_batch_solver(jmpc, **kw)(jnp.asarray(x0s),
                                                jnp.asarray(w0s))
    x1 = x0s * 1.001
    warm_in = [np.asarray(a) for a in (sol.w, sol.lam)] + \
        [np.full(B, 1e-4)] + [np.asarray(a) for a in (sol.zl, sol.zu)]
    for (uj, itj, okj), (ut, itt, okt) in (
            (j_cold(jnp.asarray(x0s), jnp.asarray(w0s)), t_cold(x0s, w0s)),
            (j_warm(*(jnp.asarray(a) for a in [x1] + warm_in)),
             t_warm(x1, *warm_in))):
        assert ut.shape == (B, 1) and itt.shape == (B,)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
        assert float(okt) == float(okj) == B


_WORKER = r"""
import json, os, sys, warnings
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["DOMPC_REPO"])
import torch.distributed as dist
import dompc_tpu_torch as dm
import dompc_tpu_torch as tdm
from dompc_tpu_torch.parallel import (init_distributed, make_sharded_solver,
                                      make_batch_solver, batch_mesh,
                                      initial_guess_from_x0)

{train}

assert init_distributed(), "init_distributed returned False"
try:
    assert dist.get_world_size() == 2
    out = dict(rank=dist.get_rank())
    model = dm.systems.oscillating_masses_model()
    mpc = dm.systems.oscillating_masses_mpc(model)
    B = int(os.environ["BATCH"])
    x0s = 0.4 * np.random.default_rng(0).standard_normal((B, 4))
    w0s = initial_guess_from_x0(mpc, x0s)
    kw = dict(tol=1e-6, throughput_mode=True)
    cold, mesh = make_sharded_solver(mpc, **kw)
    warm, _ = make_sharded_solver(mpc, mesh=mesh, warm=True, **kw)
    whole = make_batch_solver(mpc, **kw)
    sol, u_ref = whole(x0s, w0s)
    warm_in = (x0s * 1.001, sol.w, sol.lam, np.full(B, 1e-4), sol.zl,
               sol.zu)
    sol_w, u_ref_w = whole(*warm_in)
    for name, (u, it, n_ok), s, ur in (
            ("cold", cold(x0s, w0s), sol, u_ref),
            ("warm", warm(*warm_in), sol_w, u_ref_w)):
        out[name] = dict(u=u.tolist(), it=it.tolist(), n_ok=float(n_ok),
                         u_ref=ur.tolist(), it_ref=s.iterations.tolist(),
                         ok_ref=int(s.success.sum()))
    try:
        cold(x0s[:B - 1], w0s[:B - 1])
        out["indivisible"] = "no error"
    except ValueError as exc:
        out["indivisible"] = str(exc)
    try:
        batch_mesh(1)
        out["mesh_of_1"] = "no error"
    except ValueError as exc:
        out["mesh_of_1"] = str(exc)
    for bs in (64, 63):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hist, weights, world = train(bs)
        out[f"train_{bs}"] = dict(
            hist=hist, weights=weights, world=world,
            warnings=[str(w.message) for w in caught
                      if "data_parallel" in str(w.message)])
    assert not any(m in ("jax", "dompc_tpu")
                   or m.startswith(("jax.", "dompc_tpu."))
                   for m in sys.modules), "the worker imported JAX"
    print("RESULT " + json.dumps(out), flush=True)
finally:
    dist.destroy_process_group()
"""


def train(batch_size):
    """tests/test_trainer_dp.py:_train with the port (the workers run this
    function's source) (30 epochs, lr 3e-3,
    no shuffle, data_parallel on): the history, the weights and the world
    size the Trainer saw."""
    model = tdm.systems.oscillating_masses_model()
    mpc = tdm.systems.oscillating_masses_mpc(model)
    approx = tdm.approximateMPC.ApproxMPC(mpc)
    settings = tdm.approximateMPC.TrainerSettings(
        n_epochs=30, batch_size=batch_size, learning_rate=3e-3,
        print_frequency=0, shuffle=False, data_parallel=True)
    trainer = tdm.approximateMPC.Trainer(approx, settings)
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, (256, 4))
    U_prev = rng.uniform(-0.4, 0.4, (256, 1))
    U = np.clip(-0.3 * X[:, :1] + 0.1 * U_prev, -0.5, 0.5)
    hist = trainer.default_training(X, U, U_prev=U_prev, seed=0)
    weights = torch.cat([p.detach().reshape(-1).double()
                         for p in approx.net.parameters()]).tolist()
    return ({k: list(map(float, v)) for k, v in hist.items()}, weights,
            trainer._world_size)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of the port-only two-process worker."""
    worker = tmp_path_factory.mktemp("ranks") / "worker.py"
    worker.write_text(_WORKER.replace("{train}", inspect.getsource(train)))
    env = dict(os.environ, DOMPC_REPO=REPO, DOMPC_TPU_PLATFORM="cpu",
               DOMPC_TPU_X64="1", BATCH=str(B), NUM_PROCESSES="2",
               COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, str(worker)], env=dict(env, PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        line = next(l for l in out.splitlines() if l.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    assert [r["rank"] for r in results] == [0, 1]
    return results


def test_two_ranks_sharded_equals_whole_batch(two_ranks):
    for res in two_ranks:
        for call in ("cold", "warm"):
            r = res[call]
            np.testing.assert_allclose(r["u"], r["u_ref"], rtol=1e-12,
                                       atol=1e-14)
            assert r["it"] == r["it_ref"]
            assert r["n_ok"] == r["ok_ref"] == B


def test_two_ranks_indivisible_batch_raises(two_ranks):
    for res in two_ranks:
        assert "not divisible by the mesh size 2" in res["indivisible"]


def test_two_ranks_mesh_of_fewer_ranks_raises(two_ranks):
    for res in two_ranks:
        assert "batch_mesh over 1 ranks" in res["mesh_of_1"]


def test_data_parallel_two_ranks_match_one(two_ranks):
    hist, weights, world = train(64)
    assert world == 1
    for res in two_ranks:
        dp = res["train_64"]
        assert dp["world"] == 2 and not dp["warnings"]
        assert dp["hist"]["train_loss"][-1] < dp["hist"]["train_loss"][0]
        for key in ("train_loss", "val_loss", "update_norm"):
            np.testing.assert_allclose(dp["hist"][key], hist[key],
                                       rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(dp["weights"], weights, rtol=1e-6,
                                   atol=1e-7)
    # a batch of 63 does not split over 2 ranks: it trains unsharded, with
    # one warning, and so gives one process's arithmetic exactly
    hist63, weights63, _ = train(63)
    for res in two_ranks:
        un = res["train_63"]
        assert len(un["warnings"]) == 1
        assert un["hist"] == hist63 and un["weights"] == weights63
    assert two_ranks[0]["train_64"]["weights"] == \
        two_ranks[1]["train_64"]["weights"]
