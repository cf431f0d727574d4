"""Smoke run of the PyTorch port (dompc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: both band kernels from dompc_tpu_torch/csrc (band_qr.cu and
   band_sweep_tiled.cu; one nvcc per source, started together, sm_90a),
   with the build seconds and ptxas's register/spill report;
3. kernels against their plain version: band_qr in float32 and float64,
   band_sweep_tiled in float32, at the flagship shape (9 chains, S=21,
   b=13, t=12), a batch of 128 flagship problems (1152 chains), the DIP
   chain length S=101 (the tiled kernel's factors then live in global
   memory), and 1e22 diagonal entries in float32; relative error against
   the plain version, operator residual, and the kernel's, the plain
   version's and torch.linalg.solve's (dense yardstick) times;
4. make_step: the flagship robust CSTR NMPC (N=20, 9 scenarios) through
   Model -> MPC.setup() -> set_initial_guess() -> 5 make_step calls (a
   batch of one in the solver) on the card, in float32 (solver_tol 1e-4,
   60 iterations) and in float64 (in a subprocess with DOMPC_TPU_X64=1);
   the float64 pass also solves the first step with the port on the CPU
   and holds the card's u0 to it.  The band sweeps of float32 step 0 are
   recorded and band_qr is held against its plain version on those real
   KKT chains;
5. batched serving, float32: parallel.make_batch_solver on the flagship at
   B=128 (throughput_mode, tol 1e-3, 60 iterations; bench.py's states),
   one cold and one warm call, once with the default band backend and once
   with DOMPC_TPU_BAND_BACKEND=pallas_tiled; every instance certifies, u0
   in bounds, each backend launches only its kernel, once per Newton step,
   and the two backends' u0 agree.  The tiled kernel is held against its
   plain version on every band sweep recorded from the cold and the warm
   call made once more (neither timed nor counted);
6. batched equals per-instance, float64 (in the subprocess): one batched
   cold call of 4 instances at N=10 against four calls of one instance.

Every kernel counter is set to 0 just before each path and read just
after.  The last stdout line is {"ok": true, "device": {...}}; the line
before it lists the kernels, and the one before that names the card and
its power limit.  Needs CUDA; exits non-zero without it.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12                     # H100 SXM HBM3 bytes/s (data sheet)
PEAK = {"float32": 67e12,            # H100 SXM FP32 outside tensor cores
        "float64": 34e12}            # H100 SXM FP64 outside tensor cores


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------
# phase 3: kernel against twin
# --------------------------------------------------------------------------

def band_case(N, S, b, t, seed, huge=False):
    """Diagonally dominant chains from a numpy seed (|diag| >= 3b against
    off-diagonal rows summing to ~2b), so the chain systems are well
    conditioned and the error bounds below are about rounding only."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
    U = 0.5 * rng.standard_normal((N, S - 1, b, b))
    Lo = 0.5 * rng.standard_normal((N, S - 1, b, b))
    rhs = rng.standard_normal((N, S, b, t))
    if huge:
        D[:, :, 0, 0] = 1e22        # barrier-style diagonal (pallas_band.py)
    return D, U, Lo, rhs


def band_work(N, S, b, t, itemsize):
    """Bytes the sweep must move (inputs read once, x written once) and the
    floating-point operations the kernel performs."""
    n_el = N * (S * b * b + 2 * (S - 1) * b * b + 2 * S * b * t)
    n_p = 3 * b + t

    def elim(m):
        return sum(4 * (m - j) * (n_p - j) + 3 * (m - j) for j in range(b))

    per_chain = (S - 1) * elim(2 * b) + elim(b) \
        + S * b * b * t + (S - 1) * 4 * b * b * t
    return n_el * itemsize, N * per_chain


def dense_chain(D, U, Lo):
    """The chains as dense (N, S*b, S*b) matrices (for the yardstick)."""
    import torch
    N, S, b, _ = D.shape
    A = torch.zeros((N, S * b, S * b), dtype=D.dtype, device=D.device)
    for k in range(S):
        A[:, k * b:(k + 1) * b, k * b:(k + 1) * b] = D[:, k]
        if k < S - 1:
            A[:, k * b:(k + 1) * b, (k + 1) * b:(k + 2) * b] = U[:, k]
            A[:, (k + 1) * b:(k + 2) * b, k * b:(k + 1) * b] = Lo[:, k]
    return A


# (name, shape, huge diagonal, rel-error bound, residual bound).  Bounds:
# the chains are diagonally dominant (condition O(1)), so a backward-
# stable QR sweep stays within ~1e3 units of roundoff of the twin and of
# the operator: float32 eps 6e-8 -> 1e-4, float64 eps 1.1e-16 -> 1e-12.
# At S=101 in float32 the error compounds over five times as many stages;
# the residual is the check that counts there.  With a 1e22 diagonal the
# bound of tests/test_pallas_band.py:126-147 (residual 1e-3) applies.
BAND_CASES = {
    "float32": [("flagship", (9, 21, 13, 12), False, 1e-4, 1e-5),
                ("batch128", (9 * 128, 21, 13, 12), False, 1e-4, 1e-5),
                ("dip_S101", (9, 101, 13, 12), False, 1e-3, 1e-5),
                ("diag_1e22", (9, 21, 13, 12), True, 1e-3, 1e-3)],
    "float64": [("flagship", (9, 21, 13, 12), False, 1e-12, 1e-13),
                ("batch128", (9 * 128, 21, 13, 12), False, 1e-12, 1e-13),
                ("dip_S101", (9, 101, 13, 12), False, 1e-12, 1e-13)],
}


def kernel_phase():
    """Both kernels against the plain version on the BAND_CASES."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec

    kernels = [("band_qr", band_qr.band_solve, BAND_CASES),
               ("band_sweep_tiled", band_qr.band_solve_tiled,
                {"float32": BAND_CASES["float32"]})]
    rows = []
    for kname, kernel, table in kernels:
        for dname, cases in table.items():
            dt = getattr(torch, dname)
            for seed, (name, shape, huge, rel_max, res_max) in \
                    enumerate(cases):
                N, S, b, t = shape
                D, U, Lo, rhs = [torch.as_tensor(a, dtype=dt, device="cuda")
                                 for a in band_case(*shape, seed, huge)]
                x = kernel(D, U, Lo, rhs)
                torch.cuda.synchronize()
                # the plain version's reference runs on a CPU copy of the
                # same inputs: on the card its batched torch.linalg.qr
                # overflows in float32 on a 1e22 diagonal and returns NaN
                # (measured on the H100), while LAPACK's Householder norm
                # is scaled like the kernels'
                ref = band_qr.band_solve_qr_multi(
                    *[a.cpu() for a in (D, U, Lo, rhs)])
                err = float((x.cpu() - ref).abs().max())
                rel = err / float(ref.abs().max())
                res = float((band_matvec(D, U, Lo, x) - rhs).abs().max()
                            / rhs.abs().max())
                ok = bool(torch.isfinite(x).all()) and rel <= rel_max \
                    and res <= res_max
                reps = 20 if N * S < 5000 else 5
                ms = cuda_ms(lambda: kernel(D, U, Lo, rhs), reps)
                plain_ms = cuda_ms(
                    lambda: band_qr.band_solve_qr_multi(D, U, Lo, rhs), 3)
                A = dense_chain(D, U, Lo)
                B = rhs.reshape(N, S * b, t)
                lib_ms = cuda_ms(lambda: torch.linalg.solve(A, B), 3)
                del A, B
                nbytes, flops = band_work(N, S, b, t, x.element_size())
                bound = max(nbytes / MEM_BW, flops / PEAK[dname]) * 1e3
                row = dict(kernel=kname, case=name, dtype=dname,
                           shape=list(shape), max_abs_err=err, rel_err=rel,
                           rel_bound=rel_max, residual=res,
                           residual_bound=res_max, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound,
                           bound_by="bytes" if nbytes / MEM_BW
                           >= flops / PEAK[dname] else "operations",
                           bytes=nbytes, flops=flops, ok=ok)
                if kname == "band_sweep_tiled":
                    G, f_smem, smem = band_qr.tiled_plan(S, b, t)
                    row.update(chains_per_block=G, smem_bytes=smem,
                               factors="shared" if f_smem else "global")
                print(f"{kname} " + json.dumps(row), flush=True)
                rows.append(row)
                check(ok, f"{kname} {dname} {name}: rel {rel:.2e} (bound "
                          f"{rel_max:g}), residual {res:.2e} (bound "
                          f"{res_max:g})")
    return rows


# --------------------------------------------------------------------------
# phase 4: main path
# --------------------------------------------------------------------------

def drive_main_path(n_steps, f32_settings, record=False):
    """Flagship robust CSTR on the card: returns the steps' records.  The
    launch counter is zeroed just before the steps.  With ``record``, the
    inputs of every band sweep of step 0 are kept (copies on the card) for
    :func:`check_recorded`; step 0's time then includes the copies."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    from dompc_tpu_torch.interop import mpc_state_arrays

    t0 = time.perf_counter()
    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    if f32_settings:
        # float32 production settings (as scripts/tpu_smoke.py:39-40)
        mpc.settings.solver_tol = 1e-4
        mpc.settings.solver_max_iter = 60
        mpc._create_solver()
    setup_s = time.perf_counter() - t0
    check(mpc._device.type == "cuda", f"MPC set up on {mpc._device}")
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    first_state = mpc_state_arrays(mpc)
    L = mpc.layout
    lb_u = np.array([5.0, -8500.0])
    ub_u = np.array([100.0, 0.0])
    x0 = CSTR_X0.copy()
    steps, recorded = [], []

    kernel = band_qr.band_solve
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    for k in range(n_steps):
        t1 = time.perf_counter()
        with recording("band_solve", recorded, record and k == 0):
            u0 = mpc.make_step(x0).reshape(-1)
        ms = (time.perf_counter() - t1) * 1e3
        st = mpc.solver_stats
        steps.append(dict(step=k, ms=ms, iters=st["iter_count"],
                          success=st["success"], kkt_err=st["kkt_err"],
                          x0=x0.tolist(), u0=u0.tolist()))
        print(f"  step {k}: {ms:.1f} ms, {st['iter_count']} iterations, "
              f"success={st['success']}, kkt_err={st['kkt_err']:.2e}, "
              f"u0={u0.tolist()}", flush=True)
        check(st["success"], f"make_step {k} did not certify")
        check(np.all(np.isfinite(u0)), f"make_step {k}: u0 not finite")
        check(np.all(u0 >= lb_u - 1e-6 * np.abs(lb_u))
              and np.all(u0 <= ub_u + 1e-6), f"make_step {k}: u0 {u0} "
              "outside the input bounds")
        # the next x0: the MPC's own prediction at node 1 of scenario 0
        x0 = np.asarray(mpc.opt_x_num[L.sl(("x_node", 1, 0))]) \
            * mpc._x_scaling.data
    launches = kernel.launches
    check(launches > 0, "the main path launched no band_qr kernel")
    check(band_qr.band_solve_tiled.launches == 0,
          "make_step launched the tiled kernel under the default backend")
    return dict(setup_s=setup_s, steps=steps, launches=launches,
                first_state=first_state, recorded=recorded)


@contextlib.contextmanager
def recording(name, recorded, on=True):
    """While on, keep a copy (on the card) of the inputs of every call of
    ``band_qr.<name>``, which the KKT backend looks up at each call."""
    from dompc_tpu_torch.solver import band_qr
    real = getattr(band_qr, name)

    def rec(D, U, Lo, rhs, *a, **kw):
        recorded.append([x.clone() for x in (D, U, Lo, rhs)])
        return real(D, U, Lo, rhs, *a, **kw)

    if on:
        setattr(band_qr, name, rec)
    try:
        yield
    finally:
        setattr(band_qr, name, real)


# The sweeps of a real step are barrier-scaled KKT chains: ill-conditioned,
# with diagonals up to ~1e22 in float32, so neither solver is accurate to
# float32 roundoff there.  The kernel is held to its twin's own accuracy on
# the same float32 inputs: its residual and its error against the float64
# twin within KKT_FACTOR times the twin's, plus KKT_FLOOR (~10 float32 eps)
# for inputs where the twin is exact to roundoff.
KKT_FACTOR, KKT_FLOOR = 10.0, 1e-6


def check_recorded(recorded, kname, kernel, what):
    """A kernel against its plain version on recorded band sweeps.
    Residuals are taken in float64 on the CPU, relative to max |rhs|."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec

    worst = dict(res_kernel=0.0, res_twin=0.0, err_kernel=0.0, err_twin=0.0,
                 non_finite_inputs=0)
    for i, args in enumerate(recorded):
        if not all(bool(torch.isfinite(a).all()) for a in args):
            # the last polish steps: a near-singular polish solve (1e10
            # penalties) moved the point to where the model overflows in
            # float32, so the derivatives are not finite; the IPM rejects
            # that polish
            worst["non_finite_inputs"] += 1
            continue
        x_k = kernel(*args).cpu().double()
        cpu = [a.cpu() for a in args]
        x_t = band_qr.band_solve_qr_multi(*cpu).double()
        a64 = [a.double() for a in cpu]
        x_64 = band_qr.band_solve_qr_multi(*a64)
        r_max = float(a64[3].abs().max())
        x_max = float(x_64.abs().max())

        def res(x):
            return float((band_matvec(*a64[:3], x) - a64[3]).abs().max()) \
                / r_max

        row = dict(res_kernel=res(x_k), res_twin=res(x_t),
                   err_kernel=float((x_k - x_64).abs().max()) / x_max,
                   err_twin=float((x_t - x_64).abs().max()) / x_max)
        for key, val in row.items():
            worst[key] = max(worst[key], val)
        check(np.isfinite(list(row.values())).all()
              and row["res_kernel"] <= KKT_FACTOR * row["res_twin"]
              + KKT_FLOOR
              and row["err_kernel"] <= KKT_FACTOR * row["err_twin"]
              + KKT_FLOOR,
              f"{kname} on recorded KKT sweep {i} of {what}: {row} (bound: "
              f"{KKT_FACTOR:g} x plain + {KKT_FLOOR:g})")
    worst["sweeps"] = len(recorded)
    worst["chains"] = int(recorded[0][0].shape[0]) if recorded else 0
    worst["recorded_from"] = what
    check(worst["sweeps"] > worst["non_finite_inputs"],
          f"no recorded band sweep of {what} had finite inputs")
    print(f"{kname}_kkt " + json.dumps(worst), flush=True)
    return worst


def batched_f64():
    """Phase 6 (child, float64): a batch of 4 at N=10 against four batches
    of one, same solver, same states: u0 within 1e-8, equal iterations."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (cstr_robust_mpc, CSTR_X0,
                                         bench_states)
    from dompc_tpu_torch.parallel import (make_batch_solver,
                                          initial_guess_from_x0)

    mpc = cstr_robust_mpc(n_horizon=10, n_robust=1)
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    x0s = bench_states(4, seed=1)
    W = initial_guess_from_x0(mpc, x0s)
    solve = make_batch_solver(mpc, tol=1e-8, max_iter=100)
    band_qr.band_solve.launches = 0
    t0 = time.perf_counter()
    sol, u0 = solve(x0s, W)
    wall = time.perf_counter() - t0
    launches = band_qr.band_solve.launches
    check(launches > 0, "the float64 batch launched no band_qr kernel")
    it = sol.iterations.cpu().tolist()
    check(bool(sol.success.all()), f"float64 batch did not certify: {it}")
    worst = 0.0
    for i in range(4):
        s1, u1 = solve(x0s[i:i + 1], W[i:i + 1])
        rel = float((u1[0] - u0[i]).abs().max() / u0[i].abs().max())
        worst = max(worst, rel)
        check(int(s1.iterations[0]) == it[i] and rel <= 1e-8,
              f"float64 instance {i}: batched {it[i]} iterations vs alone "
              f"{int(s1.iterations[0])}, u0 rel {rel:.2e} (bound 1e-8)")
    rec = dict(B=4, n_horizon=10, wall_s=wall, iterations=it,
               launches=launches, worst_rel_u0=worst)
    print("batched_f64 " + json.dumps(rec), flush=True)
    return rec


def main_path_f64():
    """Child process (DOMPC_TPU_X64=1): 5 float64 steps on the card, then
    the first step again with the port on the CPU from the same state; then
    the batched-equals-per-instance phase on the card."""
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    from dompc_tpu_torch.interop import load_mpc_state

    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")
    run = drive_main_path(5, f32_settings=False)
    os.environ["DOMPC_TPU_PLATFORM"] = "cpu"
    t0 = time.perf_counter()
    cpu = cstr_robust_mpc(n_horizon=20, n_robust=1)
    check(cpu._device.type == "cpu", "reference MPC is not on the CPU")
    load_mpc_state(cpu, run["first_state"])
    u_cpu = cpu.make_step(CSTR_X0).reshape(-1)
    cpu_s = time.perf_counter() - t0
    os.environ.pop("DOMPC_TPU_PLATFORM")
    u_gpu = np.asarray(run["steps"][0]["u0"])
    rel = float(np.max(np.abs(u_cpu - u_gpu)) / np.max(np.abs(u_cpu)))
    print(f"  step 0 on the CPU: u0={u_cpu.tolist()}, "
          f"{cpu.solver_stats['iter_count']} iterations, {cpu_s:.1f} s; "
          f"card vs CPU rel {rel:.2e}", flush=True)
    check(rel <= 1e-6, f"card u0 differs from the CPU port's: rel {rel:.2e}")
    run.pop("first_state")
    run.pop("recorded")
    run.update(cpu_u0=u_cpu.tolist(),
               cpu_iters=cpu.solver_stats["iter_count"], card_vs_cpu=rel)
    run["batched"] = batched_f64()
    print("F64_RESULT " + json.dumps(run), flush=True)


BATCH_B, BATCH_N = 128, 20    # phase 5: the flagship at bench.py's batch

# The two backends solve the same f32 problems to the same scaled KKT
# tolerance (1e-3) with differently rounded sweeps, so their u0 differ by
# what the tolerance allows: a 1e-3 error in the scaled input (F's scaling
# is 100) is 0.1 in F.  F must agree to 0.02 * (1 + |F|) (>= 0.12 at the
# lower bound F = 5).  Q_dot is the near-degenerate direction (bench.py:
# 180-183) and is held only to its bounds.
F_AGREE = 0.02


def batched_phase():
    """Phase 5: batched serving in float32 at B=128, both band backends."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (cstr_robust_mpc, CSTR_X0,
                                         bench_states)
    from dompc_tpu_torch.parallel import (make_batch_solver,
                                          initial_guess_from_x0)

    B = BATCH_B
    t0 = time.perf_counter()
    mpc = cstr_robust_mpc(n_horizon=BATCH_N, n_robust=1)
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    setup_s = time.perf_counter() - t0
    check(mpc._dtype == torch.float32 and mpc._device.type == "cuda",
          f"batched MPC on {mpc._device} in {mpc._dtype}")
    x0s = bench_states(B)
    W = initial_guess_from_x0(mpc, x0s)
    lb_u, ub_u = np.array([5.0, -8500.0]), np.array([100.0, 0.0])
    kernels = {"band_qr": band_qr.band_solve,
               "band_sweep_tiled": band_qr.band_solve_tiled}
    out = dict(setup_s=setup_s, B=B, runs={})
    for backend, own in (("", "band_qr"), ("pallas_tiled",
                                           "band_sweep_tiled")):
        os.environ["DOMPC_TPU_BAND_BACKEND"] = backend
        try:        # the backend is read when the KKT backend is built
            solve = make_batch_solver(mpc, tol=1e-3, max_iter=60,
                                      throughput_mode=True)
        finally:
            os.environ.pop("DOMPC_TPU_BAND_BACKEND")
        name = backend or "pallas"
        calls, prev = [], None
        for kind in ("cold", "warm"):
            for k in kernels.values():
                k.launches = 0
            steps0 = solve.ipm.newton_steps
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if prev is None:
                sol, u0 = solve(x0s, W)
            else:
                sol, u0 = solve(x0s * (1.0 + 1e-3), prev.w, prev.lam, 1e-4,
                                prev.zl, prev.zu)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = {k: fn.launches for k, fn in kernels.items()}
            steps = solve.ipm.newton_steps - steps0
            it = sol.iterations.cpu().numpy()
            ok = sol.success.cpu().numpy()
            u = u0.double().cpu().numpy()
            rec = dict(backend=name, call=kind, wall_s=wall,
                       solves_per_s=B / wall, iters_mean=float(it.mean()),
                       iters_max=int(it.max()), success_rate=float(ok.mean()),
                       newton_steps=steps, launches=launches)
            print("batched " + json.dumps(rec), flush=True)
            check(ok.all(), f"batched {name} {kind}: {int((~ok).sum())} of "
                            f"{B} instances did not certify")
            check(np.isfinite(u).all() and (u >= lb_u - 1e-6 * np.abs(lb_u))
                  .all() and (u <= ub_u + 1e-6).all(),
                  f"batched {name} {kind}: u0 not finite or out of bounds")
            other = [k for k in kernels if k != own][0]
            check(launches[own] > 0 and launches[other] == 0,
                  f"batched {name} {kind}: launches {launches}")
            # float32 takes no refinement pass: one sweep per Newton step
            check(launches[own] == steps,
                  f"batched {name} {kind}: {launches[own]} launches for "
                  f"{steps} Newton steps")
            calls.append(dict(rec, u0=u))
            prev = sol
        out["runs"][name] = calls
    worst = 0.0
    for c_a, c_b in zip(out["runs"]["pallas"], out["runs"]["pallas_tiled"]):
        F_a, F_b = c_a.pop("u0")[:, 0], c_b.pop("u0")[:, 0]
        dev = float(np.max(np.abs(F_a - F_b) / (1.0 + np.abs(F_a))))
        worst = max(worst, dev)
        check(dev <= F_AGREE, f"batched {c_a['call']}: the backends' F "
                              f"differ by {dev:.3e} (bound {F_AGREE})")
    out["F_agreement"] = worst
    print(f"  backends' F agree to {worst:.3e} (bound {F_AGREE})",
          flush=True)
    # the tiled kernel on every band sweep of the cold and warm calls again
    # (the cold call's barrier-scaled steps are the hard chains); these
    # calls are neither timed nor counted
    recorded = []
    with recording("band_solve_tiled", recorded):
        sol, _ = solve(x0s, W)
        solve(x0s * (1.0 + 1e-3), sol.w, sol.lam, 1e-4, sol.zl, sol.zu)
    out["kkt"] = check_recorded(recorded, "band_sweep_tiled",
                                band_qr.band_solve_tiled,
                                "a cold and a warm float32 batch of 128")
    return out


def summarize(tag, run):
    steps = run["steps"]
    warm = steps[1:] or steps
    return dict(
        dtype=tag, setup_s=run["setup_s"], launches=run["launches"],
        ms_per_step=[s["ms"] for s in steps],
        iters_per_step=[s["iters"] for s in steps],
        warm_ms_mean=float(np.mean([s["ms"] for s in warm])),
        warm_iters_mean=float(np.mean([s["iters"] for s in warm])),
        **({"card_vs_cpu_rel": run["card_vs_cpu"],
            "cpu_iters": run["cpu_iters"]} if "card_vs_cpu" in run else {}))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    try:
        from dompc_tpu_torch.solver import band_qr
    except ImportError as exc:
        fail(f"the port is not importable next to this script: {exc}")
    for var in ("DOMPC_TPU_PLATFORM", "DOMPC_TPU_X64",
                "DOMPC_TPU_BAND_BACKEND", "DOMPC_TPU_SPIKE",
                "DOMPC_TPU_SPIKE_F32_REFINE"):
        os.environ.pop(var, None)
    t_start = time.perf_counter()

    # 1. device
    card = card_line()
    print(f"card: {card}", flush=True)

    # 2. build
    for name, (so, build_s, log) in band_qr.build().items():
        print(f"build: {name}: {so.name} in {build_s:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernels against their plain version
    rows = kernel_phase()

    # 4. make_step, float32 here, float64 (and phase 6) in a child process
    # afterwards (one at a time: the host times are the step's own)
    print("make_step float32:", flush=True)
    run32 = drive_main_path(5, f32_settings=True, record=True)
    kkt = check_recorded(run32.pop("recorded"), "band_qr",
                         band_qr.band_solve, "float32 make_step 0")
    # 5. batched serving, float32
    print("batched serving float32, B=128:", flush=True)
    batched = batched_phase()
    env = dict(os.environ, DOMPC_TPU_X64="1")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--main-path-f64"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    out, err = child.stdout, child.stderr
    print("make_step float64 and batched float64 (subprocess):", flush=True)
    sys.stdout.write("".join(l + "\n" for l in out.splitlines()
                             if not l.startswith("F64_RESULT ")))
    check(child.returncode == 0, f"float64 child failed:\n{err[-4000:]}")
    run64 = json.loads(next(l for l in out.splitlines()
                            if l.startswith("F64_RESULT "))[11:])
    main32, main64 = summarize("float32", run32), summarize("float64", run64)
    print("main_path " + json.dumps(main32), flush=True)
    print("main_path " + json.dumps(main64), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    def row(kname, case):
        return next(r for r in rows if r["kernel"] == kname
                    and r["case"] == case and r["dtype"] == "float32")

    runs = batched["runs"]
    by_path = {
        "band_qr": {"make_step_f32": run32["launches"],
                    "make_step_f64": run64["launches"],
                    "batched_f32_B128": sum(c["launches"]["band_qr"]
                                            for c in runs["pallas"]),
                    "batched_f64_B4": run64["batched"]["launches"]},
        "band_sweep_tiled": {"batched_f32_B128_pallas_tiled": sum(
            c["launches"]["band_sweep_tiled"]
            for c in runs["pallas_tiled"])}}
    kernels = []
    for kname, src, line, main_path in (
            ("band_qr", "dompc_tpu_torch/csrc/band_qr.cu",
             "dompc_tpu/solver/pallas_band.py:244", "batched_f32_B128"),
            ("band_sweep_tiled", "dompc_tpu_torch/csrc/band_sweep_tiled.cu",
             "dompc_tpu/solver/pallas_band.py:45",
             "batched_f32_B128_pallas_tiled")):
        flag, b128 = row(kname, "flagship"), row(kname, "batch128")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": line,
            "launches": by_path[kname][main_path],
            "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
            "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
            "ms_batch128": b128["ms"], "bound_ms_batch128": b128["bound_ms"],
            "launches_by_path": by_path[kname],
            "kkt_sweeps": kkt if kname == "band_qr" else batched["kkt"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--main-path-f64"]:
        sys.path.insert(0, ROOT)
        main_path_f64()
    else:
        main()
