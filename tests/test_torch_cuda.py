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
