"""Smoke run of the PyTorch port (dompc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: both band kernels from dompc_tpu_torch/csrc (band_qr.cu and
   band_sweep_tiled.cu with band_core.cuh; one nvcc per source, started
   together, sm_90a), with the build seconds and ptxas's registers,
   shared memory and spills for every template instance; the flagship
   instances (row bucket 13) must not spill;
3. kernels against their plain version: band_qr in float32 and float64,
   band_sweep_tiled in float32, at the flagship shape (9 chains, S=21,
   b=13, t=12), a batch of 128 flagship problems (1152 chains), the DIP
   chain length S=101, the rotating-masses MHE's chain (1 chain, S=11,
   b=83, t=2), and 1e22 diagonal entries in float32; relative
   error against the plain version, operator residual, the kernel's
   device time (a loop of launches into buffers allocated beforehand,
   queued while the card sleeps, so the host is ahead:
   tools/band_probe.py:device_ms), the wrapper's time, ns per column step
   (device time over S*b), and the plain version's and
   torch.linalg.solve's (dense yardstick) times;
4. make_step: the flagship robust CSTR NMPC (N=20, 9 scenarios) through
   Model -> MPC.setup() -> set_initial_guess() -> 5 make_step calls (a
   batch of one in the solver) on the card, in float32 (solver_tol 1e-4,
   60 iterations) and in float64 (in a subprocess with DOMPC_TPU_X64=1);
   the float64 pass also solves the first step with the port on the CPU
   and holds the card's u0 to it.  The band sweeps of step 0 are recorded
   in both dtypes and band_qr is held against its plain version on those
   real KKT chains;
5. batched serving, float32: parallel.make_batch_solver on the flagship at
   B=128 (throughput_mode, tol 1e-3, 60 iterations; bench.py's states),
   one cold and one warm call, once with the default band backend and once
   with DOMPC_TPU_BAND_BACKEND=pallas_tiled; every instance certifies, u0
   in bounds, each backend launches only its kernel, once per Newton step,
   and the two backends' u0 agree.  The tiled kernel is held against its
   plain version on every band sweep recorded from the cold and the warm
   call made once more (neither timed nor counted);
6. batched equals per-instance, float64 (in the subprocess): one batched
   cold call of 4 instances at N=10 against four calls of one instance;
7. RTI serving, float32, B=128 (bench.py's two RTI rows): from phase 5's
   cold solution of the default backend, pure RTI(2) and RTI(2) with
   bounded drift 1e-4; exactly 2 iterations per pure-RTI instance, every
   drift instance certified, band_qr launched once per Newton step, F
   within F_AGREE of phase 5's converged warm call; solves/s beside the
   warm rate; band_qr held against its plain version on the sweeps of one
   more RTI call;
8. the closed loop, float64 (a second subprocess): (a) three
   cstr_simulator steps on the card against the port on the CPU, (b) the
   flagship against Simulator for 8 steps fully converged and in RTI(3)
   warm-started through make_shift_fn, held to tests/test_rti.py:93-151's
   bounds, with band_qr's launches per loop;
9. the EKF, float64 (same subprocess): the triple-tank Simulator + EKF loop
   of tests/test_ekf_lqr.py:18-51 (20 steps, seeded noise) and 3 steps of
   a continuous CSTR EKF, on the card against the port on the CPU;
10. moving-horizon estimation, float64 (a third subprocess): (a) the
   rotating-masses MHE at full width (N=10, 399 variables, p_est = Theta_1)
   for 5 steps on seeded plant measurements, with the default KKT (dense
   at this size) and with kkt_solver="tridiag" (one chain, S=11, b=83, the
   estimated parameter in the root border: band_qr's row bucket 97);
   every step certifies, the backends agree, the card agrees with the
   port on the CPU at equal iterations, band_qr launches under tridiag
   only and is held against its plain version on step 0's sweeps; (b) the
   coupled MHE + MPC loop of tests/test_mhe_rotating_masses.py:14-44 (5
   steps, seed 99) on the card against the port on the CPU, with ms per
   MPC, plant and MHE step and band_qr's launches per module.

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


# the template instances the flagship launches (row bucket 13): ptxas must
# report no spills for them
FLAGSHIP_INSTANCES = ("band_qr<float,13>", "band_qr<double,13>",
                      "band_sweep_tiled<13>")
# the instances the rotating-masses MHE launches (b=83, row bucket 97):
# reported, not gated
MHE_INSTANCES = ("band_qr<float,97>", "band_qr<double,97>")


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
                ("mhe_rotating", (1, 11, 83, 2), False, 1e-4, 1e-5),
                ("diag_1e22", (9, 21, 13, 12), True, 1e-3, 1e-3)],
    "float64": [("flagship", (9, 21, 13, 12), False, 1e-12, 1e-13),
                ("batch128", (9 * 128, 21, 13, 12), False, 1e-12, 1e-13),
                ("dip_S101", (9, 101, 13, 12), False, 1e-12, 1e-13),
                ("mhe_rotating", (1, 11, 83, 2), False, 1e-12, 1e-13)],
}


def kernel_phase():
    """Both kernels against the plain version on the BAND_CASES."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec
    from dompc_tpu_torch.tools.band_probe import device_ms

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
                # device time: launches queued into buffers allocated
                # beforehand (not counted: the counters belong to the main
                # paths), then the wrapper's time per call
                launch, _ = band_qr.launcher(kname, D, U, Lo, rhs)
                ms = device_ms(launch, 30)
                del launch
                wrapper_ms = cuda_ms(lambda: kernel(D, U, Lo, rhs), 30)
                plain_ms = cuda_ms(
                    lambda: band_qr.band_solve_qr_multi(D, U, Lo, rhs), 3)
                A = dense_chain(D, U, Lo)
                B = rhs.reshape(N, S * b, t)
                lib_ms = cuda_ms(lambda: torch.linalg.solve(A, B), 3)
                del A, B
                nbytes, flops = band_work(N, S, b, t, x.element_size())
                bound = max(nbytes / MEM_BW, flops / PEAK[dname]) * 1e3
                plan = (band_qr.tiled_plan(b, t) if kname == "band_sweep_tiled"
                        else band_qr.qr_plan(b, t, dt))
                row = dict(kernel=kname, case=name, dtype=dname,
                           shape=list(shape), max_abs_err=err, rel_err=rel,
                           rel_bound=rel_max, residual=res,
                           residual_bound=res_max, ms=ms,
                           wrapper_ms=wrapper_ms,
                           ns_per_column_step=ms * 1e6 / (S * b),
                           plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound,
                           bound_by="bytes" if nbytes / MEM_BW
                           >= flops / PEAK[dname] else "operations",
                           bytes=nbytes, flops=flops, ok=ok,
                           plan=plan._asdict())
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
# the same inputs: its residual and its error against the float64 twin
# within KKT_FACTOR times the twin's, plus KKT_FLOOR (~10 float32 eps; in
# float64 the BAND_CASES bound) for inputs where the twin is exact to
# roundoff.  In float64 the twin is the reference itself, so its error is
# taken as the distance between it and a second float64 solver (a dense LU
# solve of the chains): the kernel must agree with the plain version to 10
# times what two float64 solvers agree to.
KKT_FACTOR = 10.0
KKT_FLOOR = {"float32": 1e-6, "float64": 1e-12}


def check_recorded(recorded, kname, kernel, what):
    """A kernel against its plain version on recorded band sweeps.
    Residuals are taken in float64 on the CPU, relative to max |rhs|."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec

    worst = dict(res_kernel=0.0, res_twin=0.0, err_kernel=0.0, err_twin=0.0,
                 non_finite_inputs=0)
    dname = str(recorded[0][0].dtype).replace("torch.", "") if recorded \
        else "float32"
    floor = KKT_FLOOR[dname]
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
        a64 = [a.double() for a in cpu]
        x_64 = band_qr.band_solve_qr_multi(*a64)
        if dname == "float64":
            x_t = torch.linalg.solve(
                dense_chain(*a64[:3]),
                a64[3].reshape(a64[3].shape[0], -1, a64[3].shape[-1])
            ).reshape(x_64.shape)
        else:
            x_t = band_qr.band_solve_qr_multi(*cpu).double()
        r_max = float(a64[3].abs().max())
        x_max = float(x_64.abs().max())

        def res(x):
            return float((band_matvec(*a64[:3], x) - a64[3]).abs().max()) \
                / r_max

        row = dict(res_kernel=res(x_k),
                   res_twin=res(x_64 if dname == "float64" else x_t),
                   err_kernel=float((x_k - x_64).abs().max()) / x_max,
                   err_twin=float((x_t - x_64).abs().max()) / x_max)
        for key, val in row.items():
            worst[key] = max(worst[key], val)
        check(np.isfinite(list(row.values())).all()
              and row["res_kernel"] <= KKT_FACTOR * row["res_twin"] + floor
              and row["err_kernel"] <= KKT_FACTOR * row["err_twin"] + floor,
              f"{kname} on recorded KKT sweep {i} of {what}: {row} (bound: "
              f"{KKT_FACTOR:g} x plain + {floor:g})")
    worst["sweeps"] = len(recorded)
    worst["chains"] = int(recorded[0][0].shape[0]) if recorded else 0
    worst["recorded_from"] = what
    worst["dtype"] = dname
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
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    from dompc_tpu_torch.interop import load_mpc_state

    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")
    run = drive_main_path(5, f32_settings=False, record=True)
    run["kkt"] = check_recorded(run.pop("recorded"), "band_qr",
                                band_qr.band_solve, "float64 make_step 0")
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
            if name == "pallas" and kind == "warm":
                # phase 7 starts where bench.py's RTI rows do: from the
                # default backend's cold solution, against its warm call
                out["rti_start"] = dict(mpc=mpc, x0s=x0s, cold=prev,
                                        warm_F=u[:, 0], warm_rate=B / wall)
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


RTI_REPS = 3     # timed calls per RTI mode (phase 7)


def rti_phase(start):
    """Phase 7: bench.py's two RTI rows (bench.py:151-205) at B=128 in
    float32, from phase 5's cold solution of the default backend with the
    warm inputs x0s*(1+1e-3) and mu0 = tol/10: pure RTI(2), and RTI(2) with
    bounded drift 1e-4.  Each mode: one untimed call, then RTI_REPS timed
    calls with the counters zeroed just before them."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.parallel import make_batch_solver

    mpc, cold = start["mpc"], start["cold"]
    x1 = start["x0s"] * (1.0 + 1e-3)
    B, tol, n_rti = BATCH_B, 1e-3, 2
    lb_u, ub_u = np.array([5.0, -8500.0]), np.array([100.0, 0.0])
    kernels = {"band_qr": band_qr.band_solve,
               "band_sweep_tiled": band_qr.band_solve_tiled}
    out = dict(warm_solves_per_s=start["warm_rate"], modes={})
    solvers = {}
    for mode, extra in (("rti", {}), ("rti_drift", dict(rti_drift_tol=1e-4,
                                                        rti_extra_max=6))):
        solve = make_batch_solver(mpc, tol=tol, max_iter=60,
                                  throughput_mode=True, rti_iters=n_rti,
                                  rti_prox=1e-5, rti_step_max=10.0,
                                  rti_mu_decay=1.0, **extra)
        solvers[mode] = solve

        def call():
            return solve(x1, cold.w, cold.lam, tol / 10.0, cold.zl, cold.zu)
        call()
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        steps0 = solve.ipm.newton_steps
        t1 = time.perf_counter()
        iters = []
        for _ in range(RTI_REPS):
            sol, u0 = call()
            iters.append(sol.iterations)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / RTI_REPS
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = solve.ipm.newton_steps - steps0
        it = torch.stack(iters).cpu().numpy()
        ok = sol.success.cpu().numpy()
        kkt = sol.kkt_err.double().cpu().numpy()
        u = u0.double().cpu().numpy()
        F_rel = float(np.max(np.abs(u[:, 0] - start["warm_F"])
                             / (1.0 + np.abs(start["warm_F"]))))
        rec = dict(mode=mode, B=B, wall_s=wall, solves_per_s=B / wall,
                   iters_min=int(it.min()), iters_max=int(it.max()),
                   iters_mean=float(it.mean()), success_rate=float(ok.mean()),
                   kkt_err_max=float(kkt.max()), newton_steps=steps,
                   launches=launches,
                   rti_vs_warm_first_input_rel_err=F_rel)
        print("rti " + json.dumps(rec), flush=True)
        check(np.isfinite(u).all() and (u >= lb_u - 1e-6 * np.abs(lb_u))
              .all() and (u <= ub_u + 1e-6).all(),
              f"{mode}: u0 not finite or out of bounds")
        check(launches["band_qr"] == steps and launches["band_sweep_tiled"]
              == 0, f"{mode}: launches {launches} for {steps} Newton steps")
        check(F_rel <= F_AGREE, f"{mode}: F differs from the converged warm "
                                f"call by {F_rel:.3e} (bound {F_AGREE})")
        if mode == "rti":
            check(it.min() == it.max() == n_rti and steps == n_rti * RTI_REPS,
                  f"rti: iterations {it.min()}..{it.max()}, {steps} Newton "
                  f"steps in {RTI_REPS} calls (want exactly {n_rti} each)")
        else:
            extra_max = extra["rti_extra_max"]
            check(ok.all() and kkt.max() <= max(1e-4, tol),
                  f"rti_drift: {int((~ok).sum())} of {B} instances not "
                  f"certified, max kkt_err {kkt.max():.2e}")
            check(it.max() <= n_rti + extra_max,
                  f"rti_drift: {it.max()} iterations > {n_rti} + {extra_max}")
        out["modes"][mode] = rec
    print(f"  solves/s: warm converged {start['warm_rate']:.1f}, RTI "
          f"{out['modes']['rti']['solves_per_s']:.1f}, bounded drift "
          f"{out['modes']['rti_drift']['solves_per_s']:.1f}", flush=True)
    # band_qr on every band sweep of one more pure-RTI call (neither timed
    # nor counted)
    recorded = []
    with recording("band_solve", recorded):
        solvers["rti"](x1, cold.w, cold.lam, tol / 10.0, cold.zl, cold.zu)
    out["kkt"] = check_recorded(recorded, "band_qr", band_qr.band_solve,
                                "a float32 RTI(2) call at B=128")
    return out


# --------------------------------------------------------------------------
# phases 8 and 9: the closed loop, float64 (child process)
# --------------------------------------------------------------------------

CL_STEPS = 8           # plant steps per closed loop (tests/test_rti.py:130)
U_PLANT = np.array([[18.0, -4500.0], [25.0, -3000.0], [12.0, -6000.0]])


def closed_loop_pair(n_steps=CL_STEPS):
    """The flagship in closed loop against ``Simulator``, fully converged
    (``make_batch_solver(tol=1e-6, max_iter=80)``) and in RTI(3) warm-started
    through ``make_shift_fn`` (tests/test_rti.py:93-151), on the device of
    the environment.  Returns per-loop records and the comparison."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (cstr_robust_mpc, cstr_model,
                                         cstr_simulator, CSTR_X0)
    from dompc_tpu_torch.parallel import make_batch_solver, make_shift_fn

    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    shift = make_shift_fn(mpc)
    full = make_batch_solver(mpc, tol=1e-6, max_iter=80)
    rti = make_batch_solver(mpc, tol=1e-6, max_iter=80, throughput_mode=True,
                            rti_iters=3, rti_prox=1e-2, rti_step_max=2.0,
                            rti_mu_decay=0.1)
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    w0 = mpc.opt_x_num[None, :]
    sync = torch.cuda.synchronize if mpc._device.type == "cuda" \
        else (lambda: None)
    out = {}
    for name, solver, use_shift in (("full", full, False),
                                    ("rti", rti, True)):
        sim = cstr_simulator(cstr_model())
        sim.x0 = CSTR_X0.copy()
        x = CSTR_X0.copy()
        band_qr.band_solve.launches = 0
        band_qr.band_solve_tiled.launches = 0
        steps0 = solver.ipm.newton_steps
        sync()
        t0 = time.perf_counter()
        sol, u = solver(x[None], w0)
        sync()
        cold_ms = (time.perf_counter() - t0) * 1e3
        Fs, xs, cost = [float(u[0, 0])], [x.copy()], 0.0
        iters, ok, step_ms, sim_ms, sim_steps = [], [], [], [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            y = sim.make_step(u.double().cpu().numpy().reshape(-1, 1))
            sim_ms.append((time.perf_counter() - t0) * 1e3)
            sim_steps.append(sim.adaptive_steps)
            x = np.asarray(y).reshape(-1)
            xs.append(x)
            cost += (x[1] - 0.6) ** 2
            t0 = time.perf_counter()
            if use_shift:
                wS, lS, zlS, zuS = shift(sol)
                sol, u = solver(x[None], wS, lS, 1e-4, zlS, zuS)
            else:
                sol, u = solver(x[None], sol.w, sol.lam, 1e-4, sol.zl,
                                sol.zu)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            Fs.append(float(u[0, 0]))
            iters.append(int(sol.iterations[0]))
            ok.append(bool(sol.success[0]))
        out[name] = dict(
            F=Fs, x=[v.tolist() for v in xs], cost=cost, cold_ms=cold_ms,
            step_ms=step_ms, iters=iters, success=ok, sim_ms=sim_ms,
            sim_adaptive_steps=sim_steps,
            newton_steps=solver.ipm.newton_steps - steps0,
            launches={"band_qr": band_qr.band_solve.launches,
                      "band_sweep_tiled": band_qr.band_solve_tiled.launches})
    F_full, F_rti = np.array(out["full"]["F"]), np.array(out["rti"]["F"])
    x_full, x_rti = np.array(out["full"]["x"]), np.array(out["rti"]["x"])
    out["F_rel_max"] = float(np.max(np.abs(F_rti - F_full)
                                    / (1 + np.abs(F_full))))
    out["x_rel_max"] = float(np.max(np.abs(x_rti - x_full)
                                    / (1 + np.abs(x_full))))
    out["cost_ratio"] = out["rti"]["cost"] / out["full"]["cost"]
    return out


def closed_loop_faults(res):
    """The bounds of tests/test_rti.py:147-151 plus the step semantics:
    every full step certifies, every warm RTI step takes exactly 3
    iterations, and the RTI loop sweeps twice per Newton step (float64,
    one refinement pass)."""
    faults = []
    if res["F_rel_max"] > 6e-2:
        faults.append(f"F rel err {res['F_rel_max']:.3e} > 6e-2")
    if res["x_rel_max"] > 2e-2:
        faults.append(f"state rel err {res['x_rel_max']:.3e} > 2e-2")
    if not 0.7 <= res["cost_ratio"] <= 1.3:
        faults.append(f"cost ratio {res['cost_ratio']:.3f} outside [0.7, 1.3]")
    if not all(res["full"]["success"]):
        faults.append(f"full loop steps not certified: {res['full']}")
    if res["rti"]["iters"] != [3] * len(res["rti"]["iters"]):
        faults.append(f"RTI iterations {res['rti']['iters']} (want 3)")
    return faults


def plant_run(n=len(U_PLANT)):
    """``cstr_simulator`` from CSTR_X0 under U_PLANT on the device of the
    environment: the states and each step's ms and adaptive steps."""
    from dompc_tpu_torch.systems import cstr_model, cstr_simulator, CSTR_X0
    sim = cstr_simulator(cstr_model())
    sim.x0 = CSTR_X0
    ms, steps = [], []
    for k in range(n):
        t0 = time.perf_counter()
        sim.make_step(U_PLANT[k].reshape(-1, 1))
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(sim.adaptive_steps)
    return dict(x=np.vstack([sim.data._x, sim.x0.data[None]]), ms=ms,
                adaptive_steps=steps, device=str(sim._device))


def tank_tvp_fun(tmpl):
    def tvp_fun(t_now):
        tmpl["tvp1"] = 0.5 if t_now < 50 else 1.0
        return tmpl
    return tvp_fun


def ekf_run(n_steps=20, seed=42):
    """The triple-tank Simulator + EKF loop of tests/test_ekf_lqr.py:18-51
    (seeded measurement noise), then 3 EKF steps on the continuous CSTR
    (covariance through the adaptive integrator), on the device of the
    environment."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.systems import triple_tank_model, cstr_model

    model = triple_tank_model()
    sim = dm.Simulator(model)
    sim.set_param(t_step=1)
    p_t = sim.get_p_template()
    p_t["p1"] = 2
    sim.set_p_fun(lambda t: p_t)
    sim.set_tvp_fun(tank_tvp_fun(sim.get_tvp_template()))
    sim.setup()
    ekf = dm.estimator.EKF(model)
    ekf.settings.t_step = 1
    p_te = ekf.get_p_template()
    p_te["p1"] = 2
    ekf.set_p_fun(lambda t: p_te)
    ekf.set_tvp_fun(tank_tvp_fun(ekf.get_tvp_template()))
    ekf.setup()
    Q = np.diag(1e-3 * np.ones(model.n_x))
    R = np.diag(1e-2 * np.ones(model.n_y))
    sim.x0 = np.array([2, 2.8, 2.7])
    ekf.x0 = np.array([1.2, 1.4, 1.8])
    sim.set_initial_guess()
    ekf.set_initial_guess()
    rng = np.random.default_rng(seed)
    u0 = np.array([[0.0001], [0.0001]])
    ekf_ms = []
    for _ in range(n_steps):
        y = sim.make_step(u0, v0=0.001 * rng.standard_normal((model.n_v, 1)))
        t0 = time.perf_counter()
        ekf.make_step(y_next=y, u_next=u0, Q_k=Q, R_k=R)
        ekf_ms.append((time.perf_counter() - t0) * 1e3)
    # continuous: the CSTR
    cekf = dm.estimator.EKF(cstr_model())
    cekf.settings.t_step = 0.005
    p_c = cekf.get_p_template()
    p_c["alpha"] = 1.0
    p_c["beta"] = 1.0
    cekf.set_p_fun(lambda t: p_c)
    cekf.setup()
    cekf.x0 = np.array([0.8, 0.5, 134.14, 130.0])
    cekf.P0 = np.diag([0.01, 0.01, 1.0, 1.0])
    cekf.set_initial_guess()
    Qc = np.diag([1e-4, 1e-4, 1e-2, 1e-2])
    Rc = np.diag([1e-3, 1e-3, 1e-1, 1e-1])
    c_ms, c_steps = [], []
    for k in range(3):
        y = np.array([0.85, 0.52, 134.0, 129.8]) * (1.0 + 1e-3 * k)
        t0 = time.perf_counter()
        cekf.make_step(y_next=y, u_next=U_PLANT[0].reshape(-1, 1), Q_k=Qc,
                       R_k=Rc)
        c_ms.append((time.perf_counter() - t0) * 1e3)
        c_steps.append(cekf.adaptive_steps)
    return dict(tank_x=ekf.data._x, tank_P=ekf.P0, plant_x=sim.data._x,
                tank_ekf_ms=ekf_ms, cstr_x=cekf.data._x, cstr_P=cekf.P0,
                cstr_ekf_ms=c_ms, cstr_adaptive_steps=c_steps,
                device=str(ekf._device))


def on_cpu(fn, *args):
    """``fn(*args)`` with the port on the CPU (the yardstick of the card
    runs), asked for explicitly."""
    os.environ["DOMPC_TPU_PLATFORM"] = "cpu"
    try:
        return fn(*args)
    finally:
        os.environ.pop("DOMPC_TPU_PLATFORM")


def _rel_max(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def closed_loop_f64():
    """Child process (DOMPC_TPU_X64=1): phases 8 and 9.  The CPU runs of
    the port are the yardstick of 8a and 9."""
    from dompc_tpu_torch.solver import band_qr

    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")

    rec = {}
    # 8a: the plant
    gpu, cpu = plant_run(), on_cpu(plant_run)
    check(gpu["device"].startswith("cuda") and cpu["device"] == "cpu",
          f"plant devices {gpu['device']} / {cpu['device']}")
    rel = _rel_max(gpu["x"], cpu["x"])
    rec["plant"] = dict(card_vs_cpu=rel, ms=gpu["ms"],
                        adaptive_steps=gpu["adaptive_steps"],
                        cpu_ms=cpu["ms"])
    print("plant " + json.dumps(rec["plant"]), flush=True)
    check(rel <= 1e-9, f"plant on the card vs the CPU: rel {rel:.2e} "
                       "(bound 1e-9)")
    # 8b: full against RTI
    t0 = time.perf_counter()
    res = closed_loop_pair()
    res["wall_s"] = time.perf_counter() - t0
    for name in ("full", "rti"):
        loop = res[name]
        print(f"closed_loop_{name} " + json.dumps(
            {k: loop[k] for k in ("cold_ms", "step_ms", "iters", "success",
                                  "sim_ms", "sim_adaptive_steps",
                                  "newton_steps", "launches")}), flush=True)
    print(f"  F rel {res['F_rel_max']:.3e} (bound 6e-2), x rel "
          f"{res['x_rel_max']:.3e} (bound 2e-2), cost ratio "
          f"{res['cost_ratio']:.4f} (bound [0.7, 1.3])", flush=True)
    faults = closed_loop_faults(res)
    check(not faults, "closed loop: " + "; ".join(faults))
    for name in ("full", "rti"):
        n = res[name]["launches"]
        check(n["band_qr"] > 0 and n["band_sweep_tiled"] == 0,
              f"closed loop {name}: launches {n}")
    n_rti = res["rti"]
    check(n_rti["launches"]["band_qr"] == 2 * n_rti["newton_steps"],
          f"closed loop rti: {n_rti['launches']} launches for "
          f"{n_rti['newton_steps']} Newton steps (want 2 each)")
    rec["closed_loop"] = {k: res[k] for k in ("F_rel_max", "x_rel_max",
                                              "cost_ratio", "wall_s")}
    rec["closed_loop"].update({
        f"{name}_{key}": res[name][key] for name in ("full", "rti")
        for key in ("cold_ms", "step_ms", "iters", "sim_ms",
                    "sim_adaptive_steps", "newton_steps", "launches")})
    # 9: EKF
    gpu, cpu = ekf_run(), on_cpu(ekf_run)
    rel = max(_rel_max(gpu[k], cpu[k]) for k in ("tank_x", "tank_P",
                                                 "plant_x", "cstr_x",
                                                 "cstr_P"))
    rec["ekf"] = dict(card_vs_cpu=rel, tank_ekf_ms=gpu["tank_ekf_ms"],
                      cstr_ekf_ms=gpu["cstr_ekf_ms"],
                      cstr_adaptive_steps=gpu["cstr_adaptive_steps"],
                      cpu_tank_ekf_ms=cpu["tank_ekf_ms"],
                      cpu_cstr_ekf_ms=cpu["cstr_ekf_ms"])
    print("ekf " + json.dumps(rec["ekf"]), flush=True)
    check(gpu["device"].startswith("cuda"), f"EKF on {gpu['device']}")
    check(rel <= 1e-9, f"EKF on the card vs the CPU: rel {rel:.2e} "
                       "(bound 1e-9)")
    check(band_qr.band_solve_tiled.launches == 0, "tiled kernel launched")
    print("CL_RESULT " + json.dumps(rec), flush=True)


# --------------------------------------------------------------------------
# phase 10: moving-horizon estimation, float64 (child process)
# --------------------------------------------------------------------------

MHE_STEPS = 5          # estimator steps of 10a
LOOP_STEPS = 5         # coupled-loop steps of 10b (the test's 5)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def mhe_measurements(n=MHE_STEPS, seed=7):
    """Phase 10a's measurements: ``rotating_masses_simulator`` from a seeded
    random state under a constant input (tests/test_mhe_p_est_bounds.py:
    62-78), on the device of the environment."""
    from dompc_tpu_torch.systems import (rotating_masses_model,
                                         rotating_masses_simulator)
    model = rotating_masses_model()
    sim = rotating_masses_simulator(model)
    sim.x0 = np.random.default_rng(seed).random(model.n_x) - 0.5
    u0 = np.array([[0.5], [-0.5]])
    return [np.asarray(sim.make_step(u0)).reshape(-1) for _ in range(n)]


def mhe_run(ys, kkt_solver, record=False):
    """``rotating_masses_mhe`` (N=10) with ``kkt_solver`` for one step per
    measurement, on the device of the environment; the launch counters are
    zeroed just before the steps.  With ``record``, step 0's band sweeps
    are kept for :func:`check_recorded`."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (rotating_masses_model,
                                         rotating_masses_mhe)
    t0 = time.perf_counter()
    model = rotating_masses_model()
    mhe = rotating_masses_mhe(model)
    if mhe.settings.kkt_solver != kkt_solver:
        mhe.settings.kkt_solver = kkt_solver
        mhe._create_solver()
    setup_s = time.perf_counter() - t0
    mhe.x0 = np.zeros(model.n_x)
    mhe.p_est0 = 1e-4
    mhe.set_initial_guess()
    dev = mhe._device
    steps, recorded = [], []
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    for k, y in enumerate(ys):
        _sync(dev)
        t1 = time.perf_counter()
        with recording("band_solve", recorded, record and k == 0):
            x = mhe.make_step(y).reshape(-1)
        _sync(dev)
        st = mhe.solver_stats
        steps.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                          iters=st["iter_count"], success=st["success"],
                          kkt_err=st["kkt_err"], x=x.tolist(),
                          p_est=float(mhe._p_est0.data[0])))
    asm = getattr(mhe, "_kkt_structure", None)
    return dict(
        kkt_solver=kkt_solver, device=str(dev), setup_s=setup_s,
        n_opt_x=mhe.n_opt_x, steps=steps,
        launches={"band_qr": band_qr.band_solve.launches,
                  "band_sweep_tiled": band_qr.band_solve_tiled.launches},
        structure=None if asm is None else [asm.C, asm.S, asm.b, asm.R],
        recorded=recorded)


def coupled_loop_run(n_steps=LOOP_STEPS):
    """The coupled loop of tests/test_mhe_rotating_masses.py:14-44 (seed
    99): ``mpc.make_step`` -> ``Simulator.make_step`` -> ``mhe.make_step``
    on the device of the environment, with each module's ms and band
    launches per step."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (
        rotating_masses_model, rotating_masses_mpc,
        rotating_masses_simulator, rotating_masses_mhe)
    model = rotating_masses_model()
    mpc = rotating_masses_mpc(model)
    sim = rotating_masses_simulator(model)
    mhe = rotating_masses_mhe(model)
    dev = mpc._device
    np.random.seed(99)
    x0_true = np.random.rand(model.n_x) - 0.5
    x0 = np.zeros(model.n_x)
    mpc.x0 = x0
    sim.x0 = x0_true
    mhe.x0 = x0
    mhe.p_est0 = 1e-4
    mpc.set_initial_guess()
    mhe.set_initial_guess()
    rec = {k: [] for k in ("u", "y", "x", "p_est", "mpc_ms", "sim_ms",
                           "mhe_ms", "mpc_iters", "mhe_iters",
                           "mpc_success", "mhe_success")}
    launches = {"mpc": 0, "sim": 0, "mhe": 0}

    def timed(name, fn, arg):
        n0 = band_qr.band_solve.launches
        _sync(dev)
        t1 = time.perf_counter()
        out = np.asarray(fn(arg)).reshape(-1)
        _sync(dev)
        rec[name + "_ms"].append((time.perf_counter() - t1) * 1e3)
        launches[name] += band_qr.band_solve.launches - n0
        return out

    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    for _ in range(n_steps):
        u0 = timed("mpc", mpc.make_step, x0)
        y = timed("sim", sim.make_step, u0.reshape(-1, 1))
        x0 = timed("mhe", mhe.make_step, y)
        for key, val in (("u", u0), ("y", y), ("x", x0)):
            rec[key].append(val.tolist())
        rec["p_est"].append(float(mhe._p_est0.data[0]))
        for name, obj in (("mpc", mpc), ("mhe", mhe)):
            rec[f"{name}_iters"].append(obj.solver_stats["iter_count"])
            rec[f"{name}_success"].append(bool(obj.solver_stats["success"]))
    rec.update(launches=launches, device=str(dev),
               tiled_launches=band_qr.band_solve_tiled.launches,
               mpc_kkt=("condensed" if hasattr(mpc, "_kkt_structure_cond")
                        else "bbd" if hasattr(mpc, "_kkt_structure")
                        else "dense"),
               mhe_kkt="bbd" if hasattr(mhe, "_kkt_structure") else "dense")
    return rec


def _p_rel(a, b):
    """Relative difference of two estimated-parameter sequences (the
    parameter is ~1e-4, so a difference relative to max(1, |b|) would be
    no check)."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def mhe_f64():
    """Child process (DOMPC_TPU_X64=1): phase 10.  The CPU runs of the port
    are the yardstick."""
    from dompc_tpu_torch.solver import band_qr

    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")

    rec = {}
    # 10a: the estimator alone, both KKT backends on the card, against the
    # port on the CPU (default backend: the two backends take the same
    # iterations, and the card's agree with each other below)
    ys = on_cpu(mhe_measurements)
    cpu = on_cpu(mhe_run, ys, "auto")
    check(cpu["device"] == "cpu", f"reference MHE on {cpu['device']}")
    runs = {}
    for kkt in ("auto", "tridiag"):
        gpu = mhe_run(ys, kkt, record=kkt == "tridiag")
        check(gpu["device"].startswith("cuda"), f"MHE on {gpu['device']}")
        for run in (gpu, cpu):
            bad = [k for k, st in enumerate(run["steps"])
                   if not st["success"]]
            check(not bad, f"MHE {run['kkt_solver']} on {run['device']}: "
                           f"steps {bad} did not certify")
        it_g = [st["iters"] for st in gpu["steps"]]
        it_c = [st["iters"] for st in cpu["steps"]]
        x_rel = _rel_max([st["x"] for st in gpu["steps"]],
                         [st["x"] for st in cpu["steps"]])
        p_rel = _p_rel([st["p_est"] for st in gpu["steps"]],
                       [st["p_est"] for st in cpu["steps"]])
        row = dict(kkt_solver=kkt, n_opt_x=gpu["n_opt_x"],
                   structure=gpu["structure"], setup_s=gpu["setup_s"],
                   ms=[st["ms"] for st in gpu["steps"]],
                   cpu_dense_ms=[st["ms"] for st in cpu["steps"]],
                   iters=it_g, cpu_dense_iters=it_c,
                   kkt_err=[st["kkt_err"] for st in gpu["steps"]],
                   p_est=[st["p_est"] for st in gpu["steps"]],
                   card_vs_cpu_x=x_rel, card_vs_cpu_p_est=p_rel,
                   launches=gpu["launches"])
        n = gpu["launches"]
        if kkt == "tridiag":
            check(gpu["structure"] == [1, 11, 83, 1],
                  f"MHE tridiag structure {gpu['structure']} (want one "
                  "chain, S=11, b=83, R=1)")
            check(n["band_qr"] > 0 and n["band_sweep_tiled"] == 0,
                  f"MHE tridiag: launches {n}")
            row["kkt"] = check_recorded(gpu["recorded"], "band_qr",
                                        band_qr.band_solve,
                                        "float64 MHE tridiag step 0")
        else:
            check(gpu["structure"] is None and n["band_qr"] == 0
                  and n["band_sweep_tiled"] == 0,
                  f"MHE auto at {gpu['n_opt_x']} variables: structure "
                  f"{gpu['structure']}, launches {n} (want the dense KKT)")
        print("mhe " + json.dumps(row), flush=True)
        check(it_g == it_c and x_rel <= 1e-6 and p_rel <= 1e-6,
              f"MHE {kkt}: card vs CPU iterations {it_g} / {it_c}, x rel "
              f"{x_rel:.2e}, p_est rel {p_rel:.2e} (bound 1e-6)")
        runs[kkt] = (row, gpu)
    x_rel = _rel_max([st["x"] for st in runs["tridiag"][1]["steps"]],
                     [st["x"] for st in runs["auto"][1]["steps"]])
    p_rel = _p_rel([st["p_est"] for st in runs["tridiag"][1]["steps"]],
                   [st["p_est"] for st in runs["auto"][1]["steps"]])
    print(f"  MHE tridiag vs dense on the card: x rel {x_rel:.2e}, p_est "
          f"rel {p_rel:.2e} (bound 1e-6)", flush=True)
    check(x_rel <= 1e-6 and p_rel <= 1e-6,
          f"MHE tridiag vs dense: x rel {x_rel:.2e}, p_est rel {p_rel:.2e}")
    rec["mhe"] = {kkt: row for kkt, (row, _) in runs.items()}
    rec["mhe_backends_x_rel"], rec["mhe_backends_p_est_rel"] = x_rel, p_rel
    # 10b: the coupled loop
    t0 = time.perf_counter()
    gpu = coupled_loop_run()
    wall = time.perf_counter() - t0
    cpu = on_cpu(coupled_loop_run)
    check(gpu["device"].startswith("cuda") and cpu["device"] == "cpu",
          f"coupled loop devices {gpu['device']} / {cpu['device']}")
    for run in (gpu, cpu):
        check(all(run["mpc_success"]) and all(run["mhe_success"]),
              f"coupled loop on {run['device']}: MPC certified "
              f"{run['mpc_success']}, MHE certified {run['mhe_success']}")
    rel = {k: _rel_max(gpu[k], cpu[k]) for k in ("u", "y", "x")}
    rel["p_est"] = _p_rel(gpu["p_est"], cpu["p_est"])
    loop = {k: gpu[k] for k in ("mpc_ms", "sim_ms", "mhe_ms", "mpc_iters",
                                "mhe_iters", "launches", "tiled_launches",
                                "mpc_kkt", "mhe_kkt")}
    loop.update(wall_s=wall, card_vs_cpu=rel, cpu_mpc_iters=cpu["mpc_iters"],
                cpu_mhe_iters=cpu["mhe_iters"], cpu_mpc_ms=cpu["mpc_ms"],
                cpu_sim_ms=cpu["sim_ms"], cpu_mhe_ms=cpu["mhe_ms"],
                p_est=gpu["p_est"])
    print("coupled_loop " + json.dumps(loop), flush=True)
    check(max(rel.values()) <= 1e-6 and gpu["mpc_iters"] == cpu["mpc_iters"]
          and gpu["mhe_iters"] == cpu["mhe_iters"],
          f"coupled loop on the card vs the CPU: {rel} (bound 1e-6), MPC "
          f"iterations {gpu['mpc_iters']} / {cpu['mpc_iters']}, MHE "
          f"{gpu['mhe_iters']} / {cpu['mhe_iters']}")
    check(gpu["launches"]["mpc"] > 0 and gpu["tiled_launches"] == 0,
          f"coupled loop: launches {gpu['launches']}, tiled "
          f"{gpu['tiled_launches']}")
    rec["coupled_loop"] = loop
    print("MHE_RESULT " + json.dumps(rec), flush=True)


def run_child(flag, timeout):
    """Run this script with ``flag`` in a float64 child; echo its lines,
    fail with its errors, return its result line's JSON."""
    env = dict(os.environ, DOMPC_TPU_X64="1")
    child = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    tag = {"--main-path-f64": "F64_RESULT ", "--closed-loop-f64":
           "CL_RESULT ", "--mhe-f64": "MHE_RESULT "}[flag]
    out = child.stdout
    sys.stdout.write("".join(l + "\n" for l in out.splitlines()
                             if not l.startswith(tag)))
    check(child.returncode == 0, f"{flag} child failed:\n"
                                 f"{child.stderr[-4000:]}")
    return json.loads(next(l for l in out.splitlines()
                           if l.startswith(tag))[len(tag):])


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

    # 2. build; ptxas's report of every template instance
    ptxas = {}
    for name, (so, build_s, log) in band_qr.build().items():
        print(f"build: {name}: {so.name} in {build_s:.2f} s", flush=True)
        for rep in band_qr.ptxas_report(log):
            print(f"  ptxas: {json.dumps(rep)}", flush=True)
            ptxas[rep["instance"]] = rep
    for inst in MHE_INSTANCES:
        print(f"  ptxas bucket 97 (MHE, b=83): {json.dumps(ptxas.get(inst))}",
              flush=True)
    if ptxas:   # empty only when build/ already held both libraries
        for inst in FLAGSHIP_INSTANCES:
            rep = ptxas.get(inst)
            check(rep is not None and rep["spill_stores"] == 0
                  and rep["spill_loads"] == 0,
                  f"ptxas: flagship instance {inst} spills or is missing: "
                  f"{rep}")

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
    # 7. RTI serving, float32, from phase 5's default-backend solution
    print("RTI serving float32, B=128:", flush=True)
    rti = rti_phase(batched.pop("rti_start"))
    print("make_step float64 and batched float64 (subprocess):", flush=True)
    run64 = run_child("--main-path-f64", 900)
    main32, main64 = summarize("float32", run32), summarize("float64", run64)
    print("main_path " + json.dumps(main32), flush=True)
    print("main_path " + json.dumps(main64), flush=True)
    # 8 and 9. the closed loop and the EKF, float64
    print("closed loop and EKF float64 (subprocess):", flush=True)
    loop64 = run_child("--closed-loop-f64", 600)
    print("closed_loop " + json.dumps(loop64), flush=True)
    # 10. moving-horizon estimation and the coupled loop, float64
    print("MHE and the coupled MHE + MPC loop float64 (subprocess):",
          flush=True)
    mhe64 = run_child("--mhe-f64", 600)
    print("mhe_phase " + json.dumps(mhe64), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    def row(kname, case):
        return next(r for r in rows if r["kernel"] == kname
                    and r["case"] == case and r["dtype"] == "float32")

    runs = batched["runs"]
    cl = loop64["closed_loop"]
    by_path = {
        "band_qr": {"make_step_f32": run32["launches"],
                    "make_step_f64": run64["launches"],
                    "batched_f32_B128": sum(c["launches"]["band_qr"]
                                            for c in runs["pallas"]),
                    "batched_f64_B4": run64["batched"]["launches"]},
        "band_sweep_tiled": {"batched_f32_B128_pallas_tiled": sum(
            c["launches"]["band_sweep_tiled"]
            for c in runs["pallas_tiled"])}}
    mhe, cpl = mhe64["mhe"], mhe64["coupled_loop"]
    for kname, paths in by_path.items():
        paths.update({
            "rti_f32_B128": rti["modes"]["rti"]["launches"][kname],
            "rti_drift_f32_B128": rti["modes"]["rti_drift"]["launches"][kname],
            "closed_loop_f64_full": cl["full_launches"][kname],
            "closed_loop_f64_rti": cl["rti_launches"][kname],
            "mhe_f64_tridiag": mhe["tridiag"]["launches"][kname],
            "mhe_f64_auto_dense": mhe["auto"]["launches"][kname]})
    by_path["band_qr"].update({
        f"coupled_loop_f64_{mod}": n for mod, n in cpl["launches"].items()})
    by_path["band_sweep_tiled"]["coupled_loop_f64"] = cpl["tiled_launches"]
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
            "wrapper_ms": flag["wrapper_ms"],
            "ns_per_column_step": flag["ns_per_column_step"],
            "ms_batch128": b128["ms"], "bound_ms_batch128": b128["bound_ms"],
            # the rotating-masses MHE's chain (1, 11, 83, 2), row bucket 97
            "mhe_rotating": {
                r["dtype"]: {k: r[k] for k in (
                    "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")}
                for r in rows if r["kernel"] == kname
                and r["case"] == "mhe_rotating"},
            "launches_by_path": by_path[kname],
            "ptxas_flagship": [ptxas.get(i) for i in FLAGSHIP_INSTANCES
                               if i.startswith(kname + "<")],
            "ptxas_bucket97": [ptxas.get(i) for i in MHE_INSTANCES
                               if i.startswith(kname + "<")],
            "kkt_sweeps": [kkt, run64["kkt"], rti["kkt"],
                           mhe["tridiag"]["kkt"]]
            if kname == "band_qr" else [batched["kkt"]]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--main-path-f64"]:
        sys.path.insert(0, ROOT)
        main_path_f64()
    elif sys.argv[1:] == ["--closed-loop-f64"]:
        sys.path.insert(0, ROOT)
        closed_loop_f64()
    elif sys.argv[1:] == ["--mhe-f64"]:
        sys.path.insert(0, ROOT)
        mhe_f64()
    else:
        main()
