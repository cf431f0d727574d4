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
   b=13, t=12), a batch of 128 flagship problems (1152 chains), the
   flagship's width at S=101, the rotating-masses MHE's chain (1 chain,
   S=11, b=83, t=2), the double inverted pendulum's chain (1, 101, 23, 1)
   and the two sweeps of its SPIKE solve (13 segments (13, 7, 23, 47),
   the reduced system (1, 12, 23, 1)), the chains of phases 13-14
   (ZOO_SHAPES: row buckets 8, 13, 16 and 32) and 1e22 diagonal entries
   in float32; relative
   error against the plain version, operator residual, the kernel's
   device time (a loop of launches into buffers allocated beforehand,
   queued while the card sleeps, so the host is ahead:
   tools/band_probe.py:device_ms), the wrapper's time, ns per column step
   (device time over S*b), and the plain version's and
   torch.linalg.solve's (dense yardstick) times;
4. make_step: the flagship robust CSTR NMPC (N=20, 9 scenarios) through
   Model -> MPC.setup() -> set_initial_guess() -> 2 make_step calls (a
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
   flagship against Simulator for 3 steps (tests/test_rti.py:93-151 takes
   8) fully converged and in RTI(3) warm-started through make_shift_fn,
   held to that test's bounds, with band_qr's launches per loop;
9. the EKF, float64 (same subprocess): the triple-tank Simulator + EKF loop
   of tests/test_ekf_lqr.py:18-51 (20 steps, seeded noise) and 1 step of
   a continuous CSTR EKF, on the card against the port on the CPU;
10. moving-horizon estimation, float64 (a third subprocess): (a) the
   rotating-masses MHE at full width (N=10, 399 variables, p_est = Theta_1)
   for 1 step on a seeded plant measurement, with the default KKT (dense
   at this size) and with kkt_solver="tridiag" (one chain, S=11, b=83, the
   estimated parameter in the root border: band_qr's row bucket 97);
   every step certifies, the backends agree, the card agrees with the
   port on the CPU at equal iterations, band_qr launches under tridiag
   only and is held against its plain version on step 0's sweeps; (b) the
   coupled MHE + MPC loop of tests/test_mhe_rotating_masses.py:14-44 (1
   of its 5 steps, seed 99) on the card against the port on the CPU, with
   ms per MPC, plant and MHE step and band_qr's launches per module;
11. the double inverted pendulum (float64 and float32, each in a
   subprocess of its own; their cold solves run side by side, all that
   follows them one child at a time): dip_model ->
   dip_mpc (N=100, Radau degree 3, one chain of S=101 stages, b=23) ->
   dip_simulator from theta = 0.9 pi (tests/test_dip.py:146-170).  In
   float64 the cold solve and 1 closed-loop step with StateFeedback,
   step 0 held against the port on the CPU (u0 and the whole solution;
   that yardstick runs in a third subprocess, beside the cold solves);
   in float32 (solver_tol 1e-4) the cold solve and 1 warm step.  Every
   step certifies; every KKT solve takes the SPIKE partition (13
   segments) and launches band_qr 2 x (1 + n_refine) times, and never
   the tiled kernel; step 0's SPIKE solves are held, kernel-SPIKE against
   the plain SPIKE on a CPU copy by backward error, and timed against the
   unpartitioned kernel (DOMPC_TPU_SPIKE=0);
12. the LQR, float64 (the float64 DIP's subprocess): the batch reactor's
   dae2odeconversion -> linearize -> discretize -> LQR loop against its
   linear model in Simulator (tests/test_more_examples.py:128-163, 5
   steps), on the card against the port on the CPU;
13. mixed-integer MPC (batched branch-and-bound): (a) float64 (a
   subprocess), the scalar discrete MINLP of tests/test_minlp_bnb.py (N=3,
   a fractional relaxation), 4 closed-loop steps with the Simulator and one
   "round" step: nodes at step 0, the incumbent equal to the brute-force
   optimum, bnb no worse than round, integral inputs with kkt_err < 1e-6,
   and the same nodes and incumbents as the port on the CPU; then
   Lotka-Volterra's integer MPC at full width (N=25, the condensed KKT for
   the relaxation: row bucket 8) for 2 closed-loop steps, u and x against
   the port on the CPU to 1e-10, the first frontier expansion's band
   sweeps (bucket 32) held to the plain version; band_qr launches per
   frontier expansion and the chains of each launch; (b) float32, the
   scalar MINLP's first step, recorded without a gate;
14. the IPM's settings and the systems zoo: (a) float32, the flagship's
   make_step with solver_n_refine_kkt=1 against the default (2 steps
   each: iterations, kkt_err, KKT solves and band_qr launches per Newton
   step); (b) float64 (a subprocess that runs beside phases 11-13): one
   flagship step with
   solver_globalization="merit" against the port on the CPU at equal
   iterations, the kinematic bicycle (5 closed-loop steps, condensed KKT:
   bucket 16) and the kite at N=40 (3 steps, condensed, its soft height
   bound within maximum_violation), each with kkt_err < 1e-6, and the
   industrial polymerization at full width (N=20, 9 scenarios, 7,726
   variables; a cold step and a warm one from its own prediction of the
   next state), step 0's u0 against the port on the CPU to 1e-8 at equal
   iterations.  The CPU yardstick of 13-14 runs in a subprocess of its
   own beside phases 11-13;
15. approximate MPC and the NLP differentiator
   (examples/CSTR_approximate_mpc/main.py,
   examples/batch_reactor_differentiator/main.py): (a) float32 (a
   subprocess beside phases 11-13), the flagship with T_R's upper bound
   140 set after setup and set up again;
   AMPCSampler.sample_open_loop_batched over the example's state box (the
   first 512 of its 1024 states, seed 0, batches of 128, tol 1e-4, 60
   iterations): every
   u finite and inside the input bounds, one band_qr launch per sweep of
   every KKT solve and never the tiled kernel, the first call's first 48
   sweeps held to the plain version by backward error (residuals and
   forward errors recorded), the success rate recorded; in float64 (the
   same subprocess) the first 128 states again, where the success gate of
   tests/test_satellites.py:102 (>= 0.9, a float64 test) applies, and on
   the states both certified the float32 F within F_AGREE of the
   float64; (b) the policy (ApproxMPC, Trainer: 400 epochs, batches of
   32, lr 3e-3) trained on the card on the certified samples, its first
   10 epochs' losses against the port on the CPU from the same weights
   (1e-3 relative), the last loss below the first; (c) the policy in
   closed loop from CSTR_X0 with u_prev = [5, 0] against cstr_simulator
   (float64) for 5 steps, u finite and in bounds, and the policy on all
   sampled states in one call against their MPC inputs (recorded);
   (d) float64 (the zoo subprocess): du0/dx0 of the oscillating masses,
   free and with the active nl_cons, against central finite differences
   of fresh solves on the card (tests/test_satellites.py:50-173: 5e-4,
   1e-4, du0/dx0 = 0 to 1e-6 with LICQ), and the flagship's du0/dx0
   after one step, its active sets and du0/dx0 against the port on the
   CPU (the 13-14 yardstick's subprocess) to 1e-8, with the size of the
   dense sensitivity system and the ms of its assembly and solve;
16. the last modules: (a) float32, after phase 7: phase 5's default-backend
   cold and warm calls (B=128) again through parallel.make_sharded_solver
   over a one-rank NCCL group made by init_distributed (one card: no
   traffic between ranks): n_ok = 128, u0 (1e-6 relative) and iterations
   (exactly) equal to phase 5's, one band_qr launch per Newton step, no
   tiled launch, solves/s beside phase 5's; (b) float32: one more warm
   flagship make_step on phase 4's MPC, then one under
   tools.profiler.trace into build/trace_smoke: the Chrome trace holds the
   range dompc_tpu_torch.MPC.solve/<n> and as many band_qr kernel events
   as the wrapper counted launches, with the kernels' summed device time;
   save_device_memory_profile writes a non-empty snapshot; (c) float64,
   in phase 8's subprocess: phase 8b's converged controller and
   cstr_simulator as two opcua.RTBase nodes over an in-memory tag store,
   2 cycles from 8b's start, u and x equal to 8b's first 2 steps to
   1e-12; then the flagship MPC itself behind RTBase (MPC.make_step) the
   same way, u and x equal to a direct make_step loop of a second MPC
   built alike to 1e-12; band_qr launches per cycle, no tiled launch, ms
   per node step; (d)
   float64, same subprocess: sysid.ONNXOperations on the 3-5-1 MLP of
   examples/tools/onnx_conversion/onnx_conversion_01.py and
   solver.structured's band_matvec, band_factor + band_solve and
   band_solve_qr on a seeded (S=21, b=13) band, card against CPU to
   1e-12.

Every kernel counter is set to 0 just before each path and read just
after.  Phases 2-7 run one after another in the main process (with
16a-b, 14's float32 flagship and 13's float32 MINLP); then the float64
subprocesses of phases 4 and 6, of 8-9 (with 16c-d), of 10 and of 13
run side by side, and the main process echoes their lines in that
order, each when its child ends; from phase 11 on, the two
cold DIP solves run beside each other, the CPU yardstick of phase 11,
phase 14's float64 subprocess and the CPU yardstick of 13-14, and each
DIP child then goes on alone but for those last two.  Phase 15 runs in a subprocess of its own
beside phases 11-13, but for the differentiator, which runs in phase 14's
float64 subprocess; phase 16 runs in the main process after phase 7 (a,
b) and in phase 8's subprocess (c, d).  Each heading carries the seconds
since the start.  The last stdout line is {"ok": true, "device": {...}}; the line
before it lists the kernels, and the one before that names the card and
its power limit.  Needs CUDA; exits non-zero without it.
"""
import contextlib
import json
import os
import signal
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
# the instances the DIP launches (b=23, row bucket 32): reported, not gated
DIP_INSTANCES = ("band_qr<float,32>", "band_qr<double,32>")
# the instances Lotka-Volterra's relaxation (b=8) and the kinematic bicycle
# (b=15) launch, row buckets 8 and 16: reported, not gated
ZOO_INSTANCES = ("band_qr<float,8>", "band_qr<double,8>",
                 "band_qr<float,16>", "band_qr<double,16>")


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
# The DIP's chains (b=23, row bucket 32): the whole chain (1, 101, 23, 1),
# which DOMPC_TPU_SPIKE=0 sweeps, and the two sweeps of its SPIKE solve,
# the 13 segments of 7 stages with 2b + 1 right-hand sides and the reduced
# system over the 12 separators.
DIP_SHAPES = (("dip_chain", (1, 101, 23, 1)),
              ("dip_spike_seg", (13, 7, 23, 47)),
              ("dip_spike_red", (1, 12, 23, 1)))
# The chains of phases 13-14 (measured with the port on the CPU): the
# condensed KKT of Lotka-Volterra's relaxation (row bucket 8), its
# branch-and-bound node batches (8 nodes through the BBD KKT, bucket 32),
# the condensed bicycles (buckets 16 and 32) and kite (bucket 13), and the
# polymerization's 9 scenario chains with their 23-column root border.
ZOO_SHAPES = (("lv_root", (1, 26, 8, 1)), ("lv_nodes", (8, 26, 32, 1)),
              ("kinematic_bicycle", (1, 11, 15, 1)),
              ("dynamic_bicycle", (1, 11, 21, 1)),
              ("kite", (1, 41, 13, 1)),
              ("industrial_poly", (9, 21, 24, 24)))
BAND_CASES = {
    "float32": [("flagship", (9, 21, 13, 12), False, 1e-4, 1e-5),
                ("batch128", (9 * 128, 21, 13, 12), False, 1e-4, 1e-5),
                ("flagship_width_S101", (9, 101, 13, 12), False, 1e-3, 1e-5),
                ("mhe_rotating", (1, 11, 83, 2), False, 1e-4, 1e-5),
                ("diag_1e22", (9, 21, 13, 12), True, 1e-3, 1e-3)]
    + [(name, shape, False, 1e-3 if shape[1] > 21 else 1e-4, 1e-5)
       for name, shape in DIP_SHAPES + ZOO_SHAPES],
    "float64": [("flagship", (9, 21, 13, 12), False, 1e-12, 1e-13),
                ("batch128", (9 * 128, 21, 13, 12), False, 1e-12, 1e-13),
                ("flagship_width_S101", (9, 101, 13, 12), False, 1e-12,
                 1e-13),
                ("mhe_rotating", (1, 11, 83, 2), False, 1e-12, 1e-13)]
    + [(name, shape, False, 1e-12, 1e-13)
       for name, shape in DIP_SHAPES + ZOO_SHAPES],
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

MAIN_STEPS = 2         # make_step calls per dtype (cut from 5 for time)

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
                first_state=first_state, recorded=recorded, mpc=mpc,
                next_x0=x0)


@contextlib.contextmanager
def recording(name, recorded, on=True, limit=None):
    """While on, keep a copy (on the card) of the inputs of every call of
    ``band_qr.<name>`` (of the first ``limit`` calls), which the KKT backend
    looks up at each call."""
    from dompc_tpu_torch.solver import band_qr
    real = getattr(band_qr, name)

    def rec(D, U, Lo, rhs, *a, **kw):
        if limit is None or len(recorded) < limit:
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
# float32 roundoff there.  Every recorded sweep is held by its normwise
# backward error, ||A x - b|| / (||A|| ||x|| + ||b||) in the infinity norm
# for each chain and right-hand side, which a backward-stable Householder
# sweep keeps near float eps however ill-conditioned the chain: the
# kernel's within KKT_FACTOR times the plain version's plus BE_FLOOR eps.
# Where the sweep is of a whole chain (``forward``), the kernel is also
# held to its twin's forward accuracy on the same inputs: its residual
# relative to max |rhs| and its error against the float64 twin within
# KKT_FACTOR times the twin's, plus KKT_FLOOR (~10 float32 eps; in float64
# the BAND_CASES bound) for inputs where the twin is exact to roundoff.  In
# float64 the twin is the reference itself, so its error is taken as the
# distance between it and a second float64 solver (a dense LU solve of the
# chains): the kernel must agree with the plain version to 10 times what
# two float64 solvers agree to.  A SPIKE segment (a piece of the chain cut
# loose from its neighbours) and a SPIKE solve are far worse conditioned
# than the chain: in float32 neither implementation keeps a correct digit
# of a segment's solution, and which lands closer on one input is luck
# (PERF.md §6), so they are held by backward error alone.
KKT_FACTOR = 10.0
KKT_FLOOR = {"float32": 1e-6, "float64": 1e-12}
BE_FLOOR = 100.0


def backward_error(D, U, Lo, rhs, x):
    """The worst normwise backward error of ``x`` over the chains and
    right-hand sides (float64 tensors on the CPU)."""
    import torch
    from dompc_tpu_torch.solver.bbd import band_matvec
    r = (band_matvec(D, U, Lo, x) - rhs).abs().amax((1, 2))     # (N, t)
    rows = D.abs().sum(-1)                                     # (N, S, b)
    rows[:, :-1] += U.abs().sum(-1)
    rows[:, 1:] += Lo.abs().sum(-1)
    den = rows.amax((1, 2))[:, None] * x.abs().amax((1, 2)) \
        + rhs.abs().amax((1, 2))
    return float((r / den.clamp_min(torch.finfo(den.dtype).tiny)).max())


def check_recorded(recorded, kname, kernel, what, twin=None, forward=True):
    """A kernel against its plain version ``twin`` (by default the plain
    sweep) on recorded band sweeps, each sweep by backward error and, with
    ``forward``, by residual and forward error.  Residuals and errors are
    taken in float64 on the CPU, relative to max |rhs| and max |x|."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec

    twin = twin or band_qr.band_solve_qr_multi

    worst = dict(be_kernel=0.0, be_twin=0.0, res_kernel=0.0, res_twin=0.0,
                 err_kernel=0.0, err_twin=0.0, non_finite_inputs=0)
    dname = str(recorded[0][0].dtype).replace("torch.", "") if recorded \
        else "float32"
    floor = KKT_FLOOR[dname]
    be_floor = BE_FLOOR * torch.finfo(getattr(torch, dname)).eps
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
        x_64 = twin(*a64)
        if dname == "float64":
            # one chain at a time: a batched multi-threaded LU of chains of
            # ~800 rows has hung in MKL's row interchanges (DLASWP) on the
            # CPU
            A = dense_chain(*a64[:3])
            B = a64[3].reshape(a64[3].shape[0], -1, a64[3].shape[-1])
            x_t = torch.stack([torch.linalg.solve(A[c], B[c])
                               for c in range(A.shape[0])]).reshape(
                                   x_64.shape)
        else:
            x_t = twin(*cpu).double()
        x_same = x_64 if dname == "float64" else x_t  # the twin in dname
        r_max = float(a64[3].abs().max())
        x_max = float(x_64.abs().max())

        def res(x):
            return float((band_matvec(*a64[:3], x) - a64[3]).abs().max()) \
                / r_max

        row = dict(be_kernel=backward_error(*a64, x_k),
                   be_twin=backward_error(*a64, x_same),
                   res_kernel=res(x_k), res_twin=res(x_same),
                   err_kernel=float((x_k - x_64).abs().max()) / x_max,
                   err_twin=float((x_t - x_64).abs().max()) / x_max)
        for key, val in row.items():
            worst[key] = max(worst[key], val)
        check(np.isfinite(list(row.values())).all()
              and row["be_kernel"] <= KKT_FACTOR * row["be_twin"] + be_floor
              and (not forward or (
                  row["res_kernel"] <= KKT_FACTOR * row["res_twin"] + floor
                  and row["err_kernel"] <= KKT_FACTOR * row["err_twin"]
                  + floor)),
              f"{kname} on recorded KKT sweep {i} of {what}: {row} (bound: "
              f"{KKT_FACTOR:g} x plain + {be_floor:g} in backward error"
              + (f", + {floor:g} in residual and error)" if forward else ")"))
    worst.update(be_bound=f"{KKT_FACTOR:g} x plain + {be_floor:g}",
                 forward_checked=forward, sweeps=len(recorded),
                 chains=int(recorded[0][0].shape[0]) if recorded else 0,
                 recorded_from=what, dtype=dname)
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
    run = drive_main_path(MAIN_STEPS, f32_settings=False, record=True)
    run.pop("mpc")
    run.pop("next_x0")
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
            if name == "pallas":
                # phase 16a repeats these calls sharded
                out.setdefault("shard_start", dict(
                    mpc=mpc, x0s=x0s, W=W, calls=[]))["calls"].append(
                    dict(u0=u, iters=it, solves_per_s=B / wall))
            if name == "pallas" and kind == "warm":
                # phase 7 starts where bench.py's RTI rows do: from the
                # default backend's cold solution, against its warm call
                out["rti_start"] = dict(mpc=mpc, x0s=x0s, cold=prev,
                                        warm_F=u[:, 0], warm_rate=B / wall)
                out["shard_start"]["cold"] = prev
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
CL_SMOKE_STEPS = 3     # phase 8's plant steps per loop (cut from 8 for time)
EKF_CSTR_STEPS = 1     # continuous CSTR EKF steps of phase 9 (cut from 3)
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
        us = [u[0].double().cpu().numpy()]
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
            us.append(u[0].double().cpu().numpy())
            iters.append(int(sol.iterations[0]))
            ok.append(bool(sol.success[0]))
        out[name] = dict(
            F=Fs, u=us, x=[v.tolist() for v in xs], cost=cost,
            cold_ms=cold_ms,
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
    out["start"] = dict(mpc=mpc, full=full, w0=w0)
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
    (seeded measurement noise), then EKF_CSTR_STEPS EKF steps on the
    continuous CSTR
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
    for k in range(EKF_CSTR_STEPS):
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
    res = closed_loop_pair(CL_SMOKE_STEPS)
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
    # 16c: the OPC UA node loop from 8b's start, against its converged loop
    rec["opcua"] = opcua_loop(res)
    # 16d: the host-side modules on the card against the CPU
    rec["host_modules"] = host_modules_on_card()
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

MHE_STEPS = 1          # estimator steps of 10a (cut from 5 for time)
LOOP_STEPS = 1         # coupled-loop steps of 10b (the test's 5, cut)


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


# --------------------------------------------------------------------------
# phases 11 and 12: the double inverted pendulum and the LQR (child process)
# --------------------------------------------------------------------------

DIP_LOOP_STEPS = 2     # float64 closed-loop steps (the test's 3, cut)
DIP_F32_WARM = 1       # float32 warm steps after the cold solve (cut from 2)
DIP_CHECKED = 24       # recorded SPIKE solves held to the plain SPIKE
LQR_STEPS = 5          # batch-reactor LQR loop steps (phase 12)


@contextlib.contextmanager
def spike_watch(record=False):
    """Count, per KKT solve of the MPC (``bbd_solve`` as the condensed KKT
    calls it), the band_qr launches, with what the partition of
    ``bbd._spike_parts`` predicts for it: 2 a sweep when partitioned (the
    segments, then the reduced system), 1 when not, times 1 + n_refine.
    While ``record`` is on, keep a copy of every SPIKE solve's chains."""
    from dompc_tpu_torch.controller import _mpc
    from dompc_tpu_torch.solver import band_qr, batchqr, bbd
    real_bbd, real_spike = _mpc.bbd_solve, batchqr.band_solve_spike_impl
    out = dict(solves=[], recorded=[], record=record)

    def bbd_solve(D, U, Lo, Bord, Root, *rest, n_refine=0,
                  backend="pallas"):
        n_parts, n_ref = bbd._spike_parts(Bord.shape[-3], D.dtype, backend,
                                          n_refine)
        # the real wrapper's counter: recording() may rebind the name
        n0 = band_qr._band_solve.launches
        res = real_bbd(D, U, Lo, Bord, Root, *rest, n_refine=n_refine,
                       backend=backend)
        out["solves"].append(dict(
            launches=band_qr._band_solve.launches - n0, n_parts=n_parts,
            n_refine=n_ref, want=(2 if n_parts else 1) * (1 + n_ref),
            chain=list(D.shape[-4:-1]) + [Bord.shape[-1]]))
        return res

    def spike(D, U, Lo, rhs, n_parts, sweep=None):
        if out["record"]:
            out["recorded"].append([x.clone() for x in (D, U, Lo, rhs)]
                                   + [n_parts])
        return real_spike(D, U, Lo, rhs, n_parts, sweep)

    _mpc.bbd_solve, batchqr.band_solve_spike_impl = bbd_solve, spike
    try:
        yield out
    finally:
        _mpc.bbd_solve, batchqr.band_solve_spike_impl = real_bbd, real_spike


def check_spike_counts(watch, what):
    """Every KKT solve was partitioned and launched band_qr 2 x (1 +
    n_refine) times."""
    solves = watch["solves"]
    check(solves, f"{what}: no KKT solve went through bbd_solve")
    bad = [v for v in solves if v["launches"] != v["want"]
           or v["n_parts"] < 2]
    check(not bad, f"{what}: KKT solves off the SPIKE count (2 x (1 + "
                   f"n_refine) launches, partitioned): {bad[:3]}")
    return dict(kkt_solves=len(solves), chain=solves[0]["chain"],
                n_parts=solves[0]["n_parts"], n_refine=solves[0]["n_refine"],
                launches_per_kkt_solve=solves[0]["want"],
                launches=sum(v["launches"] for v in solves))


def dip_cold_state(model, mpc, sim=None):
    """tests/test_dip.py:146-157: theta = 0.9 pi, pos = 0."""
    from dompc_tpu_torch.interop import mpc_state_arrays
    x0 = np.zeros(model.n_x)
    x0[1:3] = 0.9 * np.pi
    if sim is not None:
        sim.x0["theta"] = 0.9 * np.pi
        sim.x0["pos"] = 0
        x0 = sim.x0.data.copy()
        sim.init_algebraic_variables()
    mpc.x0 = x0
    mpc.set_initial_guess()
    return x0, mpc_state_arrays(mpc)


def dip_step_record(mpc, k, ms):
    st = mpc.solver_stats
    rec = dict(step=k, ms=ms, iters=st["iter_count"], success=st["success"],
               kkt_err=st["kkt_err"])
    print(f"  DIP step {k}: {ms:.1f} ms, {st['iter_count']} iterations, "
          f"success={st['success']}, kkt_err={st['kkt_err']:.2e}",
          flush=True)
    check(st["success"], f"DIP make_step {k} ({mpc._dtype}) did not "
                         f"certify: {rec}")
    return rec


def dip_wait_turn(name):
    """Phase 11's two DIP children solve their cold steps side by side;
    all that follows runs alone.  Mark this child's cold solve done and
    wait for the script's go (a line on stdin); a child run on its own
    (no DIP_SYNC_DIR) goes on at once."""
    sync = os.environ.get("DIP_SYNC_DIR")
    if sync:
        open(os.path.join(sync, name + ".cold"), "w").close()
        sys.stdin.readline()


def dip_f64_run():
    """Phase 11, float64: dip_model -> dip_mpc (N=100) -> dip_simulator on
    the card, the cold solve and DIP_LOOP_STEPS closed-loop steps with
    StateFeedback (tests/test_dip.py:146-170); step 0's SPIKE solves are
    recorded."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import dip_model, dip_mpc, dip_simulator
    t0 = time.perf_counter()
    model = dip_model()
    mpc = dip_mpc(model)
    sim = dip_simulator(model)
    est = dm.estimator.StateFeedback(model)
    setup_s = time.perf_counter() - t0
    check(mpc._device.type == "cuda", f"DIP MPC on {mpc._device}")
    x0, first = dip_cold_state(model, mpc, sim)
    steps, sim_ms, us = [], [], []
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with spike_watch(record=True) as watch:
        for k in range(DIP_LOOP_STEPS):
            t1 = time.perf_counter()
            u0 = mpc.make_step(x0)
            _sync(mpc._device)
            steps.append(dip_step_record(
                mpc, k, (time.perf_counter() - t1) * 1e3))
            watch["record"] = False
            if k == 0:
                w_first = np.array(mpc.opt_x_num, dtype=float)
                dip_wait_turn("f64")
            us.append(np.asarray(u0).reshape(-1).tolist())
            t1 = time.perf_counter()
            y = sim.make_step(u0)
            sim_ms.append((time.perf_counter() - t1) * 1e3)
            x0 = est.make_step(y)
    launches = band_qr.band_solve.launches
    tiled = band_qr.band_solve_tiled.launches
    counts = check_spike_counts(watch, "DIP float64")
    check(launches == counts["launches"] and launches > 0 and tiled == 0,
          f"DIP float64: {launches} band_qr launches, {counts['launches']} "
          f"in KKT solves, tiled {tiled}")
    return dict(setup_s=setup_s, steps=steps, sim_ms=sim_ms, u0=us,
                counts=counts, tiled_launches=tiled, first_state=first,
                w_first=w_first, recorded=watch["recorded"])


def dip_f32_run():
    """Phase 11, float32 (solver_tol 1e-4, as phase 4): the cold solve
    and DIP_F32_WARM warm steps, the next x0 being the MPC's own
    prediction."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import dip_model, dip_mpc
    model = dip_model()
    mpc = dip_mpc(model)
    mpc.settings.solver_tol = 1e-4
    mpc._create_solver()
    check(mpc._device.type == "cuda" and str(mpc._dtype) == "torch.float32",
          f"DIP float32 MPC on {mpc._device} in {mpc._dtype}")
    x0, _ = dip_cold_state(model, mpc)
    L = mpc.layout
    steps = []
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with spike_watch(record=True) as watch:
        for k in range(1 + DIP_F32_WARM):
            t1 = time.perf_counter()
            mpc.make_step(x0)
            _sync(mpc._device)
            steps.append(dip_step_record(
                mpc, k, (time.perf_counter() - t1) * 1e3))
            watch["record"] = False
            if k == 0:
                dip_wait_turn("f32")
            x0 = np.asarray(mpc.opt_x_num[L.sl(("x_node", 1, 0))]) \
                * mpc._x_scaling.data
    launches = band_qr.band_solve.launches
    tiled = band_qr.band_solve_tiled.launches
    counts = check_spike_counts(watch, "DIP float32")
    check(launches == counts["launches"] and tiled == 0,
          f"DIP float32: {launches} band_qr launches, {counts['launches']} "
          f"in KKT solves, tiled {tiled}")
    return dict(steps=steps, counts=counts, tiled_launches=tiled,
                recorded=watch["recorded"])


def spike_sweeps_check(recorded, what):
    """Recorded SPIKE solves (DIP_CHECKED of them, evenly spread) on a CPU
    copy, each held as :func:`check_recorded` says:

    * the kernel-SPIKE against the plain SPIKE, and the kernel's own
      launches inside it (the segment sweeps and the reduced systems)
      against the plain sweep on the same inputs, by backward error;
    * the same chains through the unpartitioned kernel (DOMPC_TPU_SPIKE=0)
      against the plain sweep, by backward error, residual and error;

    and each route's device time per solve."""
    import torch
    from dompc_tpu_torch.solver import band_qr, batchqr
    check(recorded, f"{what}: no SPIKE solve recorded")
    idx = np.unique(np.linspace(0, len(recorded) - 1,
                                min(DIP_CHECKED, len(recorded))).astype(int))
    sample = [recorded[i] for i in idx]
    P = sample[0][4]
    chains = [a[:4] for a in sample]

    def spike(*a):
        return batchqr.band_solve_spike_impl(*a, P)
    launched = []

    def keep(*a):
        launched.append([x.clone() for x in a])
        return band_qr.band_solve(*a)
    for a in chains:
        batchqr.band_solve_spike_impl(*a, P, sweep=keep)
    out = dict(recorded=len(recorded), n_parts=P)
    out["kernel_in_spike"] = check_recorded(launched, "band_qr_in_spike",
                                            band_qr.band_solve, what,
                                            forward=False)
    out["spike"] = check_recorded(chains, "band_qr_spike", spike, what,
                                  twin=spike, forward=False)
    out["unpartitioned"] = check_recorded(chains, "band_qr_whole",
                                          band_qr.band_solve, what)
    finite = [a for a in chains
              if all(bool(torch.isfinite(x).all()) for x in a)]
    for key, fn in (("spike_ms", spike),
                    ("unpartitioned_ms", band_qr.band_solve)):
        out[key] = cuda_ms(lambda: [fn(*a) for a in finite], 3) / len(finite)
    print("dip_spike_sweeps " + json.dumps(out), flush=True)
    return out


def lqr_run():
    """Phase 12: the batch reactor's dae2odeconversion -> linearize ->
    discretize -> LQR flow (tests/test_more_examples.py:128-163) against
    its continuous linear model in ``Simulator``, LQR_STEPS steps, on the
    device of the environment."""
    import dompc_tpu_torch as dm
    m = dm.model.Model("continuous")
    k1, k2, k3 = 25, 1, 1
    Ca = m.set_variable("_x", "Ca")
    Cb = m.set_variable("_x", "Cb")
    Ad = m.set_variable("_x", "Ad")
    Cain = m.set_variable("_u", "Cain")
    Cc = m.set_variable("_z", "Cc")
    m.set_rhs("Ca", -k1 * Ca + Cain)
    m.set_rhs("Cb", k1 * Ca - k2 * Cb + k3 * Cc)
    m.set_rhs("Ad", Cain)
    m.set_alg("exp", 1 + Ad - Ca - Cb - Cc)
    m.setup()
    linear = dm.model.linearize(dm.model.dae2odeconversion(m))
    model_dc = linear.discretize(0.5)
    lqr = dm.controller.LQR(model_dc)
    lqr.set_param(n_horizon=10, t_step=0.5)
    lqr.set_objective(Q=10 * np.identity(5), R=5 * np.identity(1))
    lqr.setup()
    sim = dm.Simulator(linear)
    sim.set_param(integration_tool="cvodes", t_step=0.5, substeps=8)
    sim.setup()
    x0 = np.array([[1.0], [0.0], [0.0], [0.0], [0.0]])
    sim.x0 = x0
    xss = np.array([[0.0], [2.0], [3.0], [0.0], [2.0]])
    lqr.set_setpoint(xss=xss, uss=model_dc.get_steady_state(xss=xss))
    lqr_ms, sim_ms = [], []
    for _ in range(LQR_STEPS):
        t0 = time.perf_counter()
        u0 = lqr.make_step(x0)
        lqr_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        x0 = sim.make_step(u0)
        sim_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(x=sim.data._x, u=sim.data._u, K=lqr.K, lqr_ms=lqr_ms,
                sim_ms=sim_ms, adaptive_steps=sim.adaptive_steps,
                device=str(sim._device))


def dip_cpu_f64():
    """Child process (DOMPC_TPU_PLATFORM=cpu, DOMPC_TPU_X64=1): the
    yardstick of phase 11, step 0 of the DIP with the port on the CPU."""
    import torch
    from dompc_tpu_torch.systems import dip_model, dip_mpc
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    model = dip_model()
    mpc = dip_mpc(model)
    check(mpc._device.type == "cpu", "reference DIP MPC is not on the CPU")
    x0, first = dip_cold_state(model, mpc)
    u0 = np.asarray(mpc.make_step(x0)).reshape(-1)
    print("DIPCPU_RESULT " + json.dumps(dict(
        u0=u0.tolist(), w=np.asarray(mpc.opt_x_num, dtype=float).tolist(),
        iters=mpc.solver_stats["iter_count"],
        success=bool(mpc.solver_stats["success"]),
        s=time.perf_counter() - t0, start=state_digest(first))), flush=True)


def dip_card_f32():
    """Child process (float32): phase 11's float32 run on the card and the
    check of its recorded SPIKE solves."""
    run = dip_f32_run()
    rec = dict(ms=[s["ms"] for s in run["steps"]],
               iters=[s["iters"] for s in run["steps"]],
               kkt_err=[s["kkt_err"] for s in run["steps"]],
               tiled_launches=run["tiled_launches"], **run["counts"])
    print("dip_f32 " + json.dumps(rec), flush=True)
    rec["sweeps"] = spike_sweeps_check(run["recorded"], "float32 DIP step 0")
    print("DIP32_RESULT " + json.dumps(rec), flush=True)


def state_digest(arrays):
    """A digest of an MPC's numeric start state (the arrays of
    ``interop.mpc_state_arrays``)."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode() + np.asarray(arrays[key], dtype=float).tobytes())
    return h.hexdigest()


def dip_lqr_f64():
    """Child process (DOMPC_TPU_X64=1): phase 11's float64 pass and phase
    12; the port on the CPU is the yardstick of the LQR loop (that of the
    DIP's step 0 runs in a process of its own, see :func:`main`)."""
    from dompc_tpu_torch.solver import band_qr

    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")
    # 11: the DIP, float64
    run = dip_f64_run()
    rec = dict(setup_s=run["setup_s"], ms=[s["ms"] for s in run["steps"]],
               iters=[s["iters"] for s in run["steps"]],
               kkt_err=[s["kkt_err"] for s in run["steps"]],
               sim_ms=run["sim_ms"], u0=run["u0"],
               tiled_launches=run["tiled_launches"], **run["counts"])
    print("dip_f64 " + json.dumps(rec), flush=True)
    rec["sweeps"] = spike_sweeps_check(run["recorded"], "float64 DIP step 0")
    rec.update(w_first=run["w_first"].tolist(),
               start=state_digest(run["first_state"]))
    # 12: LQR + Simulator
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    gpu = lqr_run()
    launches = {"band_qr": band_qr.band_solve.launches,
                "band_sweep_tiled": band_qr.band_solve_tiled.launches}
    cpu = on_cpu(lqr_run)
    check(gpu["device"].startswith("cuda") and cpu["device"] == "cpu",
          f"LQR plant devices {gpu['device']} / {cpu['device']}")
    rel = max(_rel_max(gpu[k], cpu[k]) for k in ("x", "u", "K"))
    lqr = dict(card_vs_cpu=rel, lqr_ms=gpu["lqr_ms"], sim_ms=gpu["sim_ms"],
               cpu_sim_ms=cpu["sim_ms"], launches=launches, steps=LQR_STEPS)
    print("lqr " + json.dumps(lqr), flush=True)
    check(rel <= 1e-9, f"LQR loop on the card vs the CPU: rel {rel:.2e} "
                       "(bound 1e-9)")
    check(not any(launches.values()), f"LQR loop launched {launches}")
    print("DIP_RESULT " + json.dumps(dict(f64=rec, lqr=lqr)), flush=True)


def dip_card_vs_cpu(f64, cpu):
    """Phase 11's yardstick: the card's float64 step 0 (u0 and the whole
    solution) against the port's on the CPU from the same start state."""
    check(cpu["start"] == f64.pop("start"),
          "DIP: the CPU yardstick started from another state")
    u_rel = _rel_max(f64["u0"][0], cpu["u0"])
    w_rel = _rel_max(f64.pop("w_first"), cpu["w"])
    f64.update(cpu_step0_s=cpu["s"], cpu_iters=cpu["iters"],
               card_vs_cpu_u0=u_rel, card_vs_cpu_w=w_rel)
    print(f"  DIP step 0 card vs CPU: u0 rel {u_rel:.2e}, solution rel "
          f"{w_rel:.2e}; CPU {cpu['iters']} iterations in {cpu['s']:.1f} s",
          flush=True)
    check(cpu["success"] and u_rel <= 1e-6 and w_rel <= 1e-6,
          f"DIP step 0 on the card vs the CPU: u0 rel {u_rel:.2e}, solution "
          f"rel {w_rel:.2e} (bound 1e-6), CPU certified {cpu['success']}")


def dip_phase(say, timeout=900):
    """Phases 11 and 12 in three children: the float64 DIP with the LQR
    loop, the float32 DIP, and the yardstick of the float64 step 0 (the
    port on the CPU, 4 threads).  The two cold solves and the yardstick run
    side by side; then the float64 child goes on alone (its closed-loop
    steps, the SPIKE checks and timings, the LQR loop), then the float32
    child (its warm steps, the SPIKE checks and timings)."""
    import shutil
    import tempfile
    sync = tempfile.mkdtemp(prefix="chip_smoke_dip_")
    flags = {"f64": "--dip-f64", "f32": "--dip-f32", "cpu": "--dip-cpu"}
    kids = {"f64": start_child("--dip-f64", sync=sync),
            "f32": start_child("--dip-f32", x64=False, sync=sync),
            "cpu": start_child("--dip-cpu", platform="cpu")}
    try:
        deadline = time.perf_counter() + timeout
        while not all(os.path.exists(os.path.join(sync, k + ".cold"))
                      for k in ("f64", "f32")):
            for k, proc in kids.items():
                if proc.poll() is not None and k != "cpu":
                    finish_child(proc, flags[k], 60)
                    fail(f"{flags[k]} child ended before the other's cold "
                         "solve was done")
            check(time.perf_counter() < deadline,
                  f"the DIP cold solves did not end in {timeout} s")
            time.sleep(0.5)
        say("both DIP cold solves done; the CPU yardstick:")
        cpu = finish_child(kids["cpu"], flags["cpu"], timeout)
        say("float64 goes on alone:")
        dip = finish_child(kids["f64"], flags["f64"], timeout, go=True)
        dip_card_vs_cpu(dip["f64"], cpu)
        say("float32 goes on alone:")
        dip["f32"] = finish_child(kids["f32"], flags["f32"], timeout, go=True)
    finally:
        for proc in kids.values():
            stop_child(proc)
        shutil.rmtree(sync, ignore_errors=True)
    return dip


# --------------------------------------------------------------------------
# phases 13 and 14: mixed-integer MPC, the IPM's settings, the systems zoo
# --------------------------------------------------------------------------

# the scalar discrete MINLP of tests/test_minlp_bnb.py (N=3, u in {0..3})
MINLP_A, MINLP_TARGET, MINLP_RFAC, MINLP_N, MINLP_UMAX = 0.5, 2.3, 0.05, 3, 3
MINLP_X0 = 0.3
MINLP_LOOP = 4         # its closed-loop steps (as the test)
LV_STEPS = 2           # Lotka-Volterra closed-loop steps (as the test)
LV_CHECKED = 24        # its recorded node-batch sweeps held to the plain one
BICYCLE_STEPS = 5      # kinematic bicycle closed-loop steps (the test: 25)
KITE_STEPS = 3         # kite closed-loop steps at N=40 (as the test)
KITE_H_MIN = 100.0


def minlp_scalar_mpc(strategy):
    """tests/test_minlp_bnb.py:_make_mpc through the port's API."""
    import dompc_tpu_torch as dm
    m = dm.model.Model("discrete")
    x = m.set_variable("_x", "x")
    u = m.set_variable("_u", "u", input_type_integer=True)
    m.set_rhs("x", MINLP_A * x + u)
    m.setup()
    mpc = dm.controller.MPC(m)
    s = mpc.settings
    s.n_horizon = MINLP_N
    s.t_step = 1.0
    s.minlp_strategy = strategy
    cost = (m.x["x"] - MINLP_TARGET) ** 2
    mpc.set_objective(lterm=cost, mterm=cost)
    mpc.set_rterm(u=MINLP_RFAC)
    mpc.bounds["lower", "_x", "x"] = -10
    mpc.bounds["upper", "_x", "x"] = 10
    mpc.bounds["lower", "_u", "u"] = 0
    mpc.bounds["upper", "_u", "u"] = MINLP_UMAX
    mpc.setup()
    return mpc


def minlp_exact_cost(x0, seq):
    cost, x, up = 0.0, float(x0), 0.0
    for u in seq:
        cost += (x - MINLP_TARGET) ** 2 + MINLP_RFAC * (u - up) ** 2
        x = MINLP_A * x + u
        up = u
    return cost + (x - MINLP_TARGET) ** 2


def minlp_brute_force(x0):
    import itertools
    return min((minlp_exact_cost(x0, seq), list(seq)) for seq in
               itertools.product(range(MINLP_UMAX + 1), repeat=MINLP_N))


@contextlib.contextmanager
def expansion_watch(record=False):
    """Per frontier expansion of branch-and-bound (one call of
    ``BranchAndBound._node_solve``): its nodes, band_qr's launches and the
    chains of each launch.  With ``record``, a copy of the first
    expansion's band sweeps is kept for :func:`check_recorded`."""
    from dompc_tpu_torch.solver import band_qr, minlp
    real_node, real_band = minlp.BranchAndBound._node_solve, \
        band_qr.band_solve
    out = dict(expansions=[], recorded=[], current=None)

    def band(D, U, Lo, rhs, *a, **kw):
        cur = out["current"]
        if cur is not None:
            cur["chains"].append(int(D.shape[0]))
            cur["shapes"].add(tuple(rhs.shape))
            if record and not out["expansions"]:
                out["recorded"].append([x.clone() for x in (D, U, Lo, rhs)])
        return real_band(D, U, Lo, rhs, *a, **kw)

    def node(self, *args):
        cur = dict(nodes=int(args[5].shape[0]), chains=[], shapes=set())
        out["current"] = cur
        n0 = real_band.launches
        try:
            return real_node(self, *args)
        finally:
            cur["launches"] = real_band.launches - n0
            cur["shapes"] = sorted(list(sh) for sh in cur["shapes"])
            out["expansions"].append(cur)
            out["current"] = None

    minlp.BranchAndBound._node_solve, band_qr.band_solve = node, band
    try:
        yield out
    finally:
        minlp.BranchAndBound._node_solve, band_qr.band_solve = \
            real_node, real_band


def _f_at(mpc):
    """The NLP objective at the MPC's current solution."""
    return float(mpc._f_fn(mpc._tensor(mpc.opt_x_num),
                           mpc._tensor(mpc.opt_p_num)))


def minlp_scalar_run(strategy, n_steps):
    """The scalar MINLP's closed loop on the device of the environment;
    the launch counter is zeroed just before the steps."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.solver import band_qr
    mpc = minlp_scalar_mpc(strategy)
    sim = dm.Simulator(mpc.model)
    sim.set_param(t_step=1.0)
    sim.setup()
    x0 = np.array([MINLP_X0])
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    L = mpc.layout
    steps = []
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with expansion_watch() as watch:
        for _ in range(n_steps):
            t1 = time.perf_counter()
            u0 = mpc.make_step(x0)
            _sync(mpc._device)
            st = mpc.solver_stats
            steps.append(dict(
                ms=(time.perf_counter() - t1) * 1e3, x0=float(x0[0]),
                u0=float(u0[0, 0]), seq=[float(mpc.opt_x_num[L.sl(
                    ("u", k, 0))][0]) for k in range(MINLP_N)],
                w=np.asarray(mpc.opt_x_num, dtype=float).tolist(),
                f=_f_at(mpc), nodes=st.get("bnb_nodes"),
                iters=st["iter_count"], success=bool(st["success"]),
                kkt_err=st["kkt_err"]))
            x0 = np.asarray(sim.make_step(u0)).reshape(-1)
    return dict(steps=steps, launches=band_qr.band_solve.launches,
                tiled_launches=band_qr.band_solve_tiled.launches,
                expansions=watch["expansions"], device=str(mpc._device))


def lv_run(n_steps=LV_STEPS, record=False):
    """tests/test_lotka_volterra.py's closed loop (N=25, ni=2, an integer
    input, branch-and-bound) with the condensed KKT for the relaxation, on
    the device of the environment; launches counted from just before the
    steps, per frontier expansion too."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (lotka_volterra_model_integer,
                                         lotka_volterra_mpc)
    t0 = time.perf_counter()
    model = lotka_volterra_model_integer()
    mpc = lotka_volterra_mpc(model)
    mpc.settings.kkt_solver = "condensed"
    mpc._create_solver()
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.3, substeps=4)
    sim.setup()
    setup_s = time.perf_counter() - t0
    x0 = np.array([0.5, 0.7])
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    rec = {k: [] for k in ("ms", "iters", "kkt_err", "success", "nodes")}
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with expansion_watch(record=record) as watch:
        for _ in range(n_steps):
            t1 = time.perf_counter()
            u0 = mpc.make_step(x0)
            _sync(mpc._device)
            rec["ms"].append((time.perf_counter() - t1) * 1e3)
            st = mpc.solver_stats
            for key, name in (("iters", "iter_count"), ("kkt_err", "kkt_err"),
                              ("success", "success"), ("nodes", "bnb_nodes")):
                rec[key].append(st[name])
            x0 = np.asarray(sim.make_step(u0)).reshape(-1)
    rec.update(setup_s=setup_s, u=np.asarray(mpc.data["_u"]).tolist(),
               x=np.asarray(mpc.data["_x"]).tolist(), x_end=x0.tolist(),
               launches=band_qr.band_solve.launches,
               tiled_launches=band_qr.band_solve_tiled.launches,
               expansions=watch["expansions"], recorded=watch["recorded"],
               device=str(mpc._device))
    return rec


def expansion_summary(expansions):
    """band_qr launches per frontier expansion and chains per launch."""
    return dict(
        expansions=len(expansions),
        nodes_per_expansion=[e["nodes"] for e in expansions],
        launches_per_expansion=[e["launches"] for e in expansions],
        chains_per_launch=sorted({c for e in expansions for c in e["chains"]}),
        shapes=sorted({tuple(sh) for e in expansions for sh in e["shapes"]}))


def minlp_f64():
    """Child process (DOMPC_TPU_X64=1): phase 13 on the card.  The scalar
    MINLP's three flows (against the brute-force optimum and against the
    port on the CPU) and Lotka-Volterra's closed loop (its CPU yardstick
    runs in a process of its own, :func:`zoo_cpu`)."""
    from dompc_tpu_torch.solver import band_qr
    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")
    rec = {}
    # 13a: the scalar MINLP, bnb closed loop and one round step
    gpu = minlp_scalar_run("bnb", MINLP_LOOP)
    cpu = on_cpu(minlp_scalar_run, "bnb", MINLP_LOOP)
    rnd = minlp_scalar_run("round", 1)
    check(gpu["device"].startswith("cuda") and cpu["device"] == "cpu",
          f"scalar MINLP devices {gpu['device']} / {cpu['device']}")
    best, best_seq = minlp_brute_force(MINLP_X0)
    s0 = gpu["steps"][0]
    cost_bnb = minlp_exact_cost(MINLP_X0, s0["seq"])
    cost_round = minlp_exact_cost(MINLP_X0,
                                  np.round(rnd["steps"][0]["seq"]))
    faults = []
    if not s0["nodes"] > 0:
        faults.append(f"step 0 took {s0['nodes']} nodes (want > 0)")
    if s0["seq"] != [float(v) for v in best_seq] \
            or abs(cost_bnb - best) > 1e-6:
        faults.append(f"incumbent {s0['seq']} (cost {cost_bnb}) is not the "
                      f"brute-force optimum {best_seq} (cost {best})")
    if cost_bnb > cost_round + 1e-9:
        faults.append(f"bnb cost {cost_bnb} > round cost {cost_round}")
    for k, (sg, sc) in enumerate(zip(gpu["steps"], cpu["steps"])):
        if abs(sg["u0"] - round(sg["u0"])) > 1e-8 or sg["kkt_err"] >= 1e-6:
            faults.append(f"step {k}: u0 {sg['u0']}, kkt_err "
                          f"{sg['kkt_err']:.2e}")
        if sg["nodes"] != sc["nodes"] or sg["seq"] != sc["seq"] \
                or _rel_max(sg["w"], sc["w"]) > 1e-10:
            faults.append(f"step {k}: card nodes {sg['nodes']} seq "
                          f"{sg['seq']}, CPU nodes {sc['nodes']} seq "
                          f"{sc['seq']}, incumbent rel "
                          f"{_rel_max(sg['w'], sc['w']):.2e}")
    if not gpu["launches"] > 0 or gpu["tiled_launches"]:
        faults.append(f"launches {gpu['launches']}, tiled "
                      f"{gpu['tiled_launches']}")
    rec["scalar"] = dict(
        ms=[s["ms"] for s in gpu["steps"]],
        cpu_ms=[s["ms"] for s in cpu["steps"]],
        u0=[s["u0"] for s in gpu["steps"]],
        seq0=s0["seq"], brute_force=best_seq, cost_bnb=cost_bnb,
        cost_round=cost_round, nodes=[s["nodes"] for s in gpu["steps"]],
        iters=[s["iters"] for s in gpu["steps"]],
        kkt_err=[s["kkt_err"] for s in gpu["steps"]],
        card_vs_cpu_w=max(_rel_max(a["w"], b["w"]) for a, b in
                          zip(gpu["steps"], cpu["steps"])),
        launches=gpu["launches"], tiled_launches=gpu["tiled_launches"],
        round_launches=rnd["launches"],
        **expansion_summary(gpu["expansions"]))
    print("minlp_scalar " + json.dumps(rec["scalar"]), flush=True)
    check(not faults, "scalar MINLP: " + "; ".join(faults))
    # 13b: Lotka-Volterra at full width, the first expansion's sweeps held
    # to the plain version
    lv = lv_run(record=True)
    check(lv["device"].startswith("cuda"), f"LV on {lv['device']}")
    recorded = lv.pop("recorded")
    n_pick = min(LV_CHECKED, len(recorded))
    picked = [recorded[round(j * (len(recorded) - 1) / max(n_pick - 1, 1))]
              for j in range(n_pick)]
    kkt = check_recorded(picked, "band_qr", band_qr.band_solve,
                         "float64 LV step 0, first frontier expansion")
    kkt["of_sweeps"] = len(recorded)
    summ = expansion_summary(lv.pop("expansions"))
    check(lv["launches"] > 0 and lv["tiled_launches"] == 0
          and all(lv["success"]) and max(lv["kkt_err"]) < 1e-6,
          f"LV: launches {lv['launches']}, tiled {lv['tiled_launches']}, "
          f"certified {lv['success']}, kkt_err {lv['kkt_err']}")
    lv.update(kkt=kkt, **summ)
    print("minlp_lv " + json.dumps({k: v for k, v in lv.items()
                                    if k not in ("u", "x")}), flush=True)
    rec["lv"] = lv
    print("MINLP_RESULT " + json.dumps(rec), flush=True)


def flagship_merit_step():
    """The flagship (N=20, float64) with globalization="merit": one cold
    step on the device of the environment."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    mpc.settings.solver_globalization = "merit"
    mpc._create_solver()
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    t1 = time.perf_counter()
    u0 = np.asarray(mpc.make_step(CSTR_X0)).reshape(-1)
    _sync(mpc._device)
    st = mpc.solver_stats
    return dict(ms=(time.perf_counter() - t1) * 1e3, u0=u0.tolist(),
                iters=st["iter_count"], success=bool(st["success"]),
                kkt_err=st["kkt_err"], launches=band_qr.band_solve.launches,
                tiled_launches=band_qr.band_solve_tiled.launches,
                device=str(mpc._device))


def poly_steps(n_steps):
    """The industrial polymerization at full width (N=20, 9 scenarios,
    7,726 variables): a cold step, then warm ones, each from the MPC's own
    prediction of the next state (as phase 4), on the device of the
    environment."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import (industrial_poly_model,
                                         industrial_poly_mpc,
                                         industrial_poly_x0)
    t0 = time.perf_counter()
    mpc = industrial_poly_mpc(industrial_poly_model())
    setup_s = time.perf_counter() - t0
    x0 = industrial_poly_x0()
    mpc.x0 = x0
    mpc.set_initial_guess()
    asm = getattr(mpc, "_kkt_structure_cond", None)
    L = mpc.layout
    rec = {k: [] for k in ("ms", "iters", "kkt_err", "success", "u0")}
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with spike_watch() as watch:
        for _ in range(n_steps):
            t1 = time.perf_counter()
            u0 = mpc.make_step(x0)
            _sync(mpc._device)
            rec["ms"].append((time.perf_counter() - t1) * 1e3)
            st = mpc.solver_stats
            for key, name in (("iters", "iter_count"), ("kkt_err", "kkt_err"),
                              ("success", "success")):
                rec[key].append(st[name])
            rec["u0"].append(np.asarray(u0).reshape(-1).tolist())
            x0 = np.asarray(mpc.opt_x_num[L.sl(("x_node", 1, 0))]) \
                * mpc._x_scaling.data
    chains = sorted({tuple(v["chain"]) for v in watch["solves"]})
    rec.update(setup_s=setup_s, n_opt_x=mpc.n_opt_x,
               launches=band_qr.band_solve.launches,
               tiled_launches=band_qr.band_solve_tiled.launches,
               kkt_solves=len(watch["solves"]), chains=chains,
               structure=None if asm is None else [asm.C, asm.S, asm.b,
                                                   asm.R],
               device=str(mpc._device))
    return rec


def zoo_loop(name):
    """The kinematic bicycle (N=10, BICYCLE_STEPS steps) or the kite (N=40,
    KITE_STEPS steps) in closed loop with its simulator, with the condensed
    KKT, on the device of the environment."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch import systems
    if name == "kite":
        model = systems.kite_model()
        mpc = systems.kite_mpc(model, n_horizon=40, h_min=KITE_H_MIN)
        sim = systems.kite_simulator(model)
        x0, n_steps = np.array([0.5, 0.3, 0.0]), KITE_STEPS
    else:
        model = systems.kinematic_bicycle_model()
        mpc = systems.kinematic_bicycle_mpc(model)
        sim = systems.kinematic_bicycle_simulator(model)
        x0, n_steps = np.array([0.0, 0.0, 0.0, 0.1]), BICYCLE_STEPS
    mpc.settings.kkt_solver = "condensed"
    mpc._create_solver()
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    rec = {k: [] for k in ("ms", "iters", "kkt_err", "u0", "x")}
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with spike_watch() as watch:
        for _ in range(n_steps):
            t1 = time.perf_counter()
            u0 = mpc.make_step(x0)
            _sync(mpc._device)
            rec["ms"].append((time.perf_counter() - t1) * 1e3)
            rec["iters"].append(mpc.solver_stats["iter_count"])
            rec["kkt_err"].append(mpc.solver_stats["kkt_err"])
            rec["u0"].append(np.asarray(u0).reshape(-1).tolist())
            x0 = np.asarray(sim.make_step(u0)).reshape(-1)
            rec["x"].append(x0.tolist())
    rec.update(launches=band_qr.band_solve.launches,
               tiled_launches=band_qr.band_solve_tiled.launches,
               chains=sorted({tuple(v["chain"]) for v in watch["solves"]}),
               n_opt_x=mpc.n_opt_x, device=str(mpc._device))
    return rec


def zoo_f64():
    """Child process (DOMPC_TPU_X64=1): phase 14's float64 runs and phase
    15d (the differentiator) on the card (their CPU yardstick runs in a
    process of its own)."""
    check(os.environ.get("DOMPC_TPU_X64") == "1", "child needs X64")
    rec = {"merit": flagship_merit_step()}
    print("flagship_merit " + json.dumps(rec["merit"]), flush=True)
    # 15d: the differentiator, float64 on the card
    masses = differentiator_masses()
    print("differentiator_masses " + json.dumps(masses), flush=True)
    flag = differentiator_flagship()
    print("differentiator_flagship " + json.dumps(
        {k: v for k, v in flag.items() if k != "active"}), flush=True)
    check(all(r["device"].startswith("cuda") for r in masses.values())
          and flag["device"].startswith("cuda"),
          "the differentiator did not run on the card")
    rec["differentiator"] = dict(masses=masses, flagship=flag)
    for name in ("kinematic_bicycle", "kite"):
        run = zoo_loop(name)
        print(f"zoo_{name} " + json.dumps(run), flush=True)
        rec[name] = run
        faults = []
        if not run["device"].startswith("cuda") or run["launches"] == 0 \
                or run["tiled_launches"]:
            faults.append(f"on {run['device']}, launches {run['launches']}, "
                          f"tiled {run['tiled_launches']}")
        if max(run["kkt_err"]) >= 1e-6:
            faults.append(f"kkt_err {run['kkt_err']}")
        if name == "kite":
            heights = [400.0 * np.sin(x[0]) * np.cos(x[1]) for x in run["x"]]
            run["heights"] = heights
            if min(heights) <= KITE_H_MIN - 10.0 - 1e-6:
                faults.append(f"heights {heights} below the soft bound's "
                              "maximum violation")
        elif np.abs(run["u0"]).max() > 5 + 1e-9:
            faults.append(f"inputs {run['u0']} outside [-5, 5]")
        check(not faults, f"{name}: " + "; ".join(faults))
    poly = poly_steps(2)
    print("zoo_poly " + json.dumps(poly), flush=True)
    check(poly["device"].startswith("cuda") and poly["launches"] > 0
          and poly["tiled_launches"] == 0,
          f"polymerization: on {poly['device']}, launches "
          f"{poly['launches']}, tiled {poly['tiled_launches']}")
    rec["poly"] = poly
    print("ZOO_RESULT " + json.dumps(rec), flush=True)


def zoo_cpu():
    """Child process (DOMPC_TPU_PLATFORM=cpu, DOMPC_TPU_X64=1): the
    yardstick of phases 13-15, the port on the CPU: Lotka-Volterra's
    closed loop, the flagship's merit step, the polymerization's step 0 and
    the flagship's du0/dx0.  It runs beside phases 11-14 on the card."""
    import torch
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    lv = lv_run()
    lv.pop("recorded")
    lv["expansions"] = expansion_summary(lv["expansions"])
    lv["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merit = flagship_merit_step()
    merit["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    poly = poly_steps(1)
    poly["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff = differentiator_flagship()
    diff["s"] = time.perf_counter() - t0
    print("ZOOCPU_RESULT " + json.dumps(dict(lv=lv, merit=merit, poly=poly,
                                             differentiator=diff)),
          flush=True)


def refine_f32():
    """Phase 14, float32 (the main process): the flagship's make_step with
    solver_n_refine_kkt=1 against the default, REFINE_STEPS steps each
    from the same start, KKT solves and band_qr launches counted."""
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    out = {}
    for n_ref in (0, 1):
        mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
        mpc.settings.solver_tol = 1e-4
        mpc.settings.solver_max_iter = 60
        mpc.settings.solver_n_refine_kkt = n_ref
        mpc._create_solver()
        mpc.x0 = CSTR_X0
        mpc.set_initial_guess()
        rec = {k: [] for k in ("ms", "iters", "kkt_err", "success")}
        band_qr.band_solve.launches = 0
        band_qr.band_solve_tiled.launches = 0
        with spike_watch() as watch:
            for _ in range(REFINE_STEPS):
                t1 = time.perf_counter()
                mpc.make_step(CSTR_X0)
                _sync(mpc._device)
                rec["ms"].append((time.perf_counter() - t1) * 1e3)
                for key, name in (("iters", "iter_count"),
                                  ("kkt_err", "kkt_err"),
                                  ("success", "success")):
                    rec[key].append(mpc.solver_stats[name])
        newton = mpc._solve_raw.newton_steps
        rec.update(launches=band_qr.band_solve.launches,
                   tiled_launches=band_qr.band_solve_tiled.launches,
                   kkt_solves=len(watch["solves"]), newton_steps=newton,
                   launches_per_kkt_solve=band_qr.band_solve.launches
                   / max(len(watch["solves"]), 1),
                   kkt_solves_per_newton_step=len(watch["solves"])
                   / max(newton, 1))
        print(f"refine n_refine_kkt={n_ref} " + json.dumps(rec), flush=True)
        check(all(rec["success"]) and rec["launches"] > 0,
              f"flagship float32 n_refine_kkt={n_ref}: {rec}")
        out[n_ref] = rec
    check(out[1]["kkt_solves_per_newton_step"]
          > out[0]["kkt_solves_per_newton_step"],
          "n_refine_kkt=1 added no KKT solve")
    return out


REFINE_STEPS = 2       # flagship float32 steps per n_refine_kkt setting


def zoo_card_vs_cpu(minlp, zoo, cpu):
    """Phases 13-14's yardstick: the card's float64 runs against the port's
    on the CPU."""
    lv, lv_c = minlp["lv"], cpu["lv"]
    u_rel, x_rel = _rel_max(lv["u"], lv_c["u"]), _rel_max(lv["x"], lv_c["x"])
    merit, merit_c = zoo["merit"], cpu["merit"]
    m_rel = _rel_max(merit["u0"], merit_c["u0"])
    poly, poly_c = zoo["poly"], cpu["poly"]
    p_rel = _rel_max(poly["u0"][0], poly_c["u0"][0])
    rec = dict(lv_u=u_rel, lv_x=x_rel, lv_nodes=lv["nodes"],
               lv_cpu_nodes=lv_c["nodes"], lv_cpu_ms=lv_c["ms"],
               merit_u0=m_rel, merit_iters=merit["iters"],
               merit_cpu_iters=merit_c["iters"], merit_cpu_ms=merit_c["ms"],
               poly_u0=p_rel, poly_iters=poly["iters"][0],
               poly_cpu_iters=poly_c["iters"][0], poly_cpu_ms=poly_c["ms"][0],
               cpu_s=dict(lv=lv_c["s"], merit=merit_c["s"],
                          poly=poly_c["s"]))
    print("zoo_card_vs_cpu " + json.dumps(rec), flush=True)
    check(u_rel <= 1e-10 and x_rel <= 1e-10 and lv["nodes"] == lv_c["nodes"],
          f"LV card vs CPU: u rel {u_rel:.2e}, x rel {x_rel:.2e} (bound "
          f"1e-10), nodes {lv['nodes']} / {lv_c['nodes']}")
    check(merit["success"] and merit["iters"] == merit_c["iters"]
          and m_rel <= 1e-8,
          f"flagship merit card vs CPU: iterations {merit['iters']} / "
          f"{merit_c['iters']}, u0 rel {m_rel:.2e} (bound 1e-8), certified "
          f"{merit['success']}")
    check(poly["iters"][0] == poly_c["iters"][0] and p_rel <= 1e-8,
          f"polymerization step 0 card vs CPU: iterations "
          f"{poly['iters'][0]} / {poly_c['iters'][0]}, u0 rel {p_rel:.2e} "
          "(bound 1e-8)")
    return rec


# --------------------------------------------------------------------------
# phase 15: approximate MPC (sampling, training, the policy in closed loop)
# and the NLP differentiator
# --------------------------------------------------------------------------

AMPC_PLAN = 1024       # states of the example's plan (seed 0)
AMPC_SAMPLES = 512     # of them sampled in float32 (cut from 1024 for time)
AMPC_BATCH = 128       # states per batched solve
AMPC_F64_SAMPLES = 128  # the first states sampled in float64 too
AMPC_CHECKED = 48      # the first call's first sweeps held to the plain one
AMPC_LBX = [0.2, 0.2, 100.0, 100.0]   # the example's state box
AMPC_UBX = [1.8, 1.8, 138.0, 138.0]
AMPC_EPOCHS = 400      # the example's training settings (main.py:52-54)
AMPC_CPU_EPOCHS = 10   # epochs of the CPU yardstick of the training
AMPC_LOOP = 5          # policy closed-loop steps (the example's default)
CSTR_LB_U = np.array([5.0, -8500.0])
CSTR_UB_U = np.array([100.0, 0.0])


@contextlib.contextmanager
def batch_call_watch(record=0):
    """Wrap ``parallel.make_batch_solver`` (the sampler imports it at each
    call) so that every batched call is timed (synchronized), its Newton
    steps, band launches and KKT solves counted, and the first ``record``
    band sweeps of the first call kept for :func:`check_recorded`."""
    import torch
    from dompc_tpu_torch import parallel
    from dompc_tpu_torch.solver import band_qr
    real = parallel.make_batch_solver
    out = dict(calls=[], recorded=[])

    def make(mpc, *a, **kw):
        solve = real(mpc, *a, **kw)

        def timed(x0s, w0s, *rest):
            first = bool(record) and not out["calls"]
            n0, l0, t0 = (solve.ipm.newton_steps, band_qr.band_solve.launches,
                          band_qr.band_solve_tiled.launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with spike_watch() as watch, \
                    recording("band_solve", out["recorded"], first,
                              limit=record):
                sol, u0 = solve(x0s, w0s, *rest)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            it = sol.iterations.cpu().numpy()
            solves = watch["solves"]
            out["calls"].append(dict(
                B=int(x0s.shape[0]), wall_s=wall, recorded=first,
                newton_steps=solve.ipm.newton_steps - n0,
                launches=band_qr.band_solve.launches - l0,
                tiled_launches=band_qr.band_solve_tiled.launches - t0,
                kkt_solves=len(solves),
                kkt_launches=sum(v["launches"] for v in solves),
                kkt_solves_off_count=sum(v["launches"] != v["want"]
                                         for v in solves),
                iters_mean=float(it.mean()), iters_max=int(it.max()),
                success=int(sol.success.sum())))
            return sol, u0

        timed.ipm = solve.ipm
        return timed

    parallel.make_batch_solver = make
    try:
        yield out
    finally:
        parallel.make_batch_solver = real


def ampc_mpc():
    """The flagship with T_R's upper bound 140 set after setup and set up
    again (examples/CSTR_approximate_mpc/main.py:34-35), on the device and
    in the dtype of the environment."""
    from dompc_tpu_torch.systems import cstr_robust_mpc
    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    mpc.bounds["upper", "_x", "T_R"] = 140.0
    mpc.setup()
    check(mpc._device.type == "cuda",
          f"approximate-MPC flagship on {mpc._device}")
    check(bool(np.isin(1.4, mpc._ub_opt_x)),
          "the second setup did not take T_R's upper bound")
    return mpc


def ampc_sample(mpc, n, record):
    """The first ``n`` states of the example's plan (AMPC_PLAN states
    drawn with seed 0 from the AMPC_LBX..AMPC_UBX box) solved with
    ``AMPCSampler.sample_open_loop_batched`` in batches of AMPC_BATCH (tol
    1e-4, 60 iterations, as the example), every batched call timed and
    counted; with ``record`` the first call's first AMPC_CHECKED band
    sweeps are held to the plain version.  Checks the inputs, the call count and one band_qr launch
    per sweep of every KKT solve; returns (X, U_prev, U, OK, record)."""
    import tempfile
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.approximateMPC import (AMPCSampler,
                                                AMPCSamplerSettings)
    dname = str(mpc._dtype).replace("torch.", "")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ampc_") as tmp:
        sampler = AMPCSampler(mpc, AMPCSamplerSettings(
            n_samples=AMPC_PLAN, data_dir=tmp))
        plan = sampler.default_sampling_plan(seed=0, lbx=AMPC_LBX,
                                             ubx=AMPC_UBX)[:n]
        band_qr.band_solve.launches = 0
        band_qr.band_solve_tiled.launches = 0
        t1 = time.perf_counter()
        with batch_call_watch(record=AMPC_CHECKED if record else 0) \
                as watch:
            X, U_prev, U, OK = sampler.sample_open_loop_batched(
                plan, batch_size=AMPC_BATCH, tol=1e-4, max_iter=60)
        wall = time.perf_counter() - t1
        launches = band_qr.band_solve.launches
        tiled = band_qr.band_solve_tiled.launches
        sampler.save_dataset(X, U_prev, U, OK)
    calls = watch["calls"]
    newton = sum(c["newton_steps"] for c in calls)
    kkt_solves = sum(c["kkt_solves"] for c in calls)
    timed = [c["wall_s"] for c in calls if not c["recorded"]]
    rec = dict(
        dtype=dname, n_samples=n, batch=AMPC_BATCH, wall_s=wall,
        calls=calls, success_rate=float(OK.mean()), launches=launches,
        tiled_launches=tiled, newton_steps=newton, kkt_solves=kkt_solves,
        launches_per_newton_step=launches / max(newton, 1),
        kkt_solves_per_newton_step=kkt_solves / max(newton, 1),
        s_per_call_unrecorded=timed,
        samples_per_s=AMPC_BATCH * len(timed) / max(sum(timed), 1e-9),
        u_min=U.min(0).tolist(), u_max=U.max(0).tolist())
    print(f"ampc_sampling_{dname} " + json.dumps(rec), flush=True)
    check(len(calls) == -(-n // AMPC_BATCH),
          f"{dname} sampling made {len(calls)} batched calls")
    check(np.isfinite(U).all() and (U >= CSTR_LB_U - 1e-6
                                    * np.abs(CSTR_LB_U)).all()
          and (U <= CSTR_UB_U + 1e-6).all(),
          f"{dname} sampled inputs not finite or outside the input bounds: "
          f"{rec['u_min']} .. {rec['u_max']}")
    check(launches > 0 and tiled == 0,
          f"{dname} sampling: band_qr {launches}, tiled {tiled} launches")
    # each KKT solve sweeps its chains 1 + n_refine times (float32: once),
    # one band_qr launch a sweep; the full-featured IPM's corrections
    # (ladder rungs, SOC, polish) are KKT solves of their own
    check(kkt_solves >= newton
          and launches == sum(c["kkt_launches"] for c in calls)
          and not any(c["kkt_solves_off_count"] for c in calls),
          f"{dname} sampling: {launches} launches for {kkt_solves} KKT "
          f"solves and {newton} Newton steps; KKT solves off the count: "
          f"{[c['kkt_solves_off_count'] for c in calls]}")
    if record:
        # the full-featured IPM's ladder rungs meet float32 chains so
        # ill-conditioned that the plain sweep's own error against the
        # float64 solution reaches 70 times the solution (PERF.md §6, PR
        # 8): as for SPIKE's segments, which sweep lands closer there is
        # luck, so these sweeps are held by backward error alone (their
        # residuals and errors are recorded)
        rec["kkt"] = check_recorded(watch["recorded"], "band_qr",
                                    band_qr.band_solve,
                                    f"the first {dname} sampling call",
                                    forward=False)
    return X, U_prev, U, OK, rec


def ampc_sampling_f64():
    """Phase 15a, float64: the first AMPC_F64_SAMPLES states of the plan,
    where tests/test_satellites.py:102's gate (success rate >= 0.9, a
    float64 test) applies."""
    os.environ["DOMPC_TPU_X64"] = "1"     # read at setup
    try:
        mpc = ampc_mpc()
    finally:
        os.environ.pop("DOMPC_TPU_X64")
    X, U_prev, U, OK, rec = ampc_sample(mpc, AMPC_F64_SAMPLES, False)
    check(OK.mean() >= 0.9, f"float64 sampling success rate {OK.mean():.3f}"
                            " (gate 0.9, tests/test_satellites.py:102)")
    rec.update(U=U.tolist(), OK=OK.astype(int).tolist())
    return rec


def ampc_f32_vs_f64(U32, OK32, rec64):
    """Phase 15a's yardstick of the float32 sampling: on the states both
    dtypes solved, certified in both, F within F_AGREE (both certify at a
    scaled KKT error of 1e-4; Q_dot, the near-degenerate input, is held to
    its bounds only)."""
    n = len(rec64["OK"])
    U64, OK64 = np.asarray(rec64["U"]), np.asarray(rec64["OK"], bool)
    both = OK32[:n] & OK64
    dev = np.abs(U32[:n, 0] - U64[:, 0]) / (1.0 + np.abs(U64[:, 0]))
    rec = dict(states=n, certified_f32=int(OK32[:n].sum()),
               certified_f64=int(OK64.sum()), certified_both=int(both.sum()),
               f32_only=int((OK32[:n] & ~OK64).sum()),
               F_dev_max=float(dev[both].max()) if both.any() else None)
    print("ampc_f32_vs_f64 " + json.dumps(rec), flush=True)
    check(both.any() and rec["F_dev_max"] <= F_AGREE,
          f"float32 vs float64 sampling: {rec} (bound {F_AGREE})")
    return rec


def ampc_phase():
    """Phase 15 (a-c), float32 in the main process: AMPC_SAMPLES states
    sampled through the batched solver, the policy trained on the card (and
    AMPC_CPU_EPOCHS epochs on the CPU port from the same weights), then run
    in closed loop against cstr_simulator."""
    import torch
    from dompc_tpu_torch.systems import CSTR_X0, cstr_simulator
    from dompc_tpu_torch.approximateMPC import (ApproxMPC, Trainer,
                                                TrainerSettings)

    t0 = time.perf_counter()
    mpc = ampc_mpc()
    check(mpc._dtype == torch.float32, f"phase 15 main in {mpc._dtype}")
    out = dict(setup_twice_s=time.perf_counter() - t0)
    # (a) sampling; the success rate is recorded here and gated in float64
    X, U_prev, U, OK, out["sampling"] = ampc_sample(mpc, AMPC_SAMPLES, True)
    out["U"], out["OK"] = U, OK

    # (b) training, on the card and (AMPC_CPU_EPOCHS) on the CPU
    Xo, Upo, Uo = X[OK], U_prev[OK], U[OK]
    approx = ApproxMPC(mpc)
    cpu = ApproxMPC(mpc)
    cpu.net.load_state_dict(approx.net.state_dict())
    cpu.net.to("cpu")
    check(approx.device.type == "cuda" and cpu.device.type == "cpu",
          f"policies on {approx.device} / {cpu.device}")

    def settings(n_epochs):
        return TrainerSettings(n_epochs=n_epochs, batch_size=32,
                               learning_rate=3e-3, print_frequency=0)

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = Trainer(approx, settings(AMPC_EPOCHS)).default_training(
        Xo, Uo, U_prev=Upo, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    steps = AMPC_EPOCHS * max(1, int(0.8 * len(Xo)) // 32)
    t1 = time.perf_counter()
    hist_cpu = Trainer(cpu, settings(AMPC_CPU_EPOCHS)).default_training(
        Xo, Uo, U_prev=Upo, seed=0)
    cpu_s = time.perf_counter() - t1
    n = AMPC_CPU_EPOCHS
    agree = {k: float(np.max(np.abs(np.subtract(hist[k][:n], hist_cpu[k]))
                             / np.abs(hist_cpu[k])))
             for k in ("train_loss", "val_loss")}
    train = dict(n_train=int(0.8 * len(Xo)), epochs=AMPC_EPOCHS,
                 steps=steps, wall_s=train_s,
                 ms_per_step=train_s * 1e3 / steps,
                 train_loss_first=hist["train_loss"][0],
                 train_loss_last=hist["train_loss"][-1],
                 val_loss_last=hist["val_loss"][-1],
                 cpu_epochs=n, cpu_s=cpu_s, card_vs_cpu_rel=agree)
    print("ampc_training " + json.dumps(train), flush=True)
    check(hist["train_loss"][-1] < hist["train_loss"][0],
          f"training loss did not fall: {train}")
    check(max(agree.values()) <= 1e-3,
          f"the first {n} epochs' losses, card vs CPU: {agree} (bound 1e-3)")
    out["training"] = train

    # (c) the policy in closed loop with the plant (float64 on the card),
    # as the example runs it, and on every sampled state at once
    os.environ["DOMPC_TPU_X64"] = "1"
    try:
        sim = cstr_simulator(mpc.model)
    finally:
        os.environ.pop("DOMPC_TPU_X64")
    x = CSTR_X0.copy()
    sim.x0 = x.copy()
    u_prev = np.array([5.0, 0.0])
    loop = {k: [] for k in ("policy_ms", "plant_ms", "u0", "x")}
    for k in range(AMPC_LOOP):
        t1 = time.perf_counter()
        u0 = approx.make_step(x, u_prev=u_prev, clip_to_bounds=True)
        loop["policy_ms"].append((time.perf_counter() - t1) * 1e3)
        u = u0.reshape(-1)
        check(np.isfinite(u).all() and (u >= CSTR_LB_U).all()
              and (u <= CSTR_UB_U).all(),
              f"policy step {k}: u {u} not finite or out of bounds")
        t1 = time.perf_counter()
        x = np.asarray(sim.make_step(u0)).reshape(-1)
        loop["plant_ms"].append((time.perf_counter() - t1) * 1e3)
        check(np.isfinite(x).all(), f"plant step {k}: x {x} not finite")
        loop["u0"].append(u.tolist())
        loop["x"].append(x.tolist())
        u_prev = u
    inp = torch.as_tensor(approx.scale_inputs(np.concatenate(
        [X, U_prev], axis=1)), dtype=approx.dtype, device=approx.device)
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: approx.net(inp), 20)
        y = approx.net(inp).double().cpu().numpy()
    err = np.abs(approx.rescale_outputs(y)[OK] - U[OK]) / approx.out_range
    loop.update(policy_batch=len(X), policy_batch_ms=batch_ms,
                scaled_err_mean=err.mean(0).tolist(),
                scaled_err_max=err.max(0).tolist())
    print("ampc_policy " + json.dumps(loop), flush=True)
    out["policy"] = loop
    return out


def du0_dx0_fd(build, x0, eps, rows):
    """Central finite differences of u0 over fresh solves: d u0 / d x0[i]
    for i in ``rows``."""
    cols = []
    for i in rows:
        us = []
        for sgn in (1.0, -1.0):
            mpc = build()
            xp = x0.copy()
            xp[i] += sgn * eps
            mpc.x0 = xp
            mpc.set_initial_guess()
            us.append(np.asarray(mpc.make_step(xp)).reshape(-1))
        cols.append((us[0] - us[1]) / (2 * eps))
    return np.stack(cols, axis=1)


def masses_nl_cons_mpc():
    """tests/test_satellites.py:124-140: the oscillating masses with the
    nl_cons u <= 0.3."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.systems import oscillating_masses_model
    model = oscillating_masses_model()
    mpc = dm.controller.MPC(model)
    mpc.settings.n_horizon = 7
    mpc.settings.t_step = 0.5
    mpc.set_objective(mterm=model.aux["cost"], lterm=model.aux["cost"])
    mpc.set_rterm(u=1e-4)
    max_x = np.array([[4.0], [10.0], [4.0], [10.0]])
    mpc.bounds["lower", "_x", "x"] = -max_x
    mpc.bounds["upper", "_x", "x"] = max_x
    mpc.bounds["lower", "_u", "u"] = -0.5
    mpc.bounds["upper", "_u", "u"] = 0.5
    mpc.set_nl_cons("ulim", model.u["u"], ub=0.3)
    mpc.setup()
    return mpc


def differentiator_masses():
    """Phase 15d on the oscillating masses (the device of the environment):
    du0/dx0 against central finite differences of fresh solves, free
    (tests/test_satellites.py:50-81, atol 5e-4) and with the active nl_cons
    (:122-173, 1e-4 for the first two states; du0/dx0 = 0 to 1e-6, LICQ)."""
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.systems import (oscillating_masses_model,
                                         oscillating_masses_mpc)
    x0 = np.random.RandomState(99).rand(4) - 0.5
    rec = {}
    for case, build, rows, atol in (
            ("free", lambda: oscillating_masses_mpc(
                oscillating_masses_model()), range(4), 5e-4),
            ("active", masses_nl_cons_mpc, range(2), 1e-4)):
        t1 = time.perf_counter()
        mpc = build()
        mpc.x0 = x0
        mpc.set_initial_guess()
        u0 = float(np.asarray(mpc.make_step(x0)).reshape(-1)[0])
        diff = dm.differentiator.DoMPCDifferentiator(mpc)
        diff.settings.check_LICQ = True
        diff.settings.check_SC = True
        du = diff.du0_dx0()
        fd = du0_dx0_fd(build, x0, 1e-5, rows)
        err = float(np.max(np.abs(du[:, list(rows)] - fd)))
        rec[case] = dict(u0=u0, du0_dx0=du.tolist(), fd=fd.tolist(),
                         err=err, atol=atol, LICQ=diff.status.LICQ,
                         SC=diff.status.SC, residuals=diff.status.residuals,
                         device=str(mpc._device),
                         s=time.perf_counter() - t1)
        faults = []
        if err > atol:
            faults.append(f"du0/dx0 vs finite differences {err:.2e} "
                          f"(atol {atol:g})")
        if case == "active":
            lam_h = mpc.lam_g_num[mpc.n_opt_lagr:]
            if abs(u0 - 0.3) >= 1e-5 or np.max(lam_h) <= 1e-4:
                faults.append(f"nl_cons not active: u0 {u0}, max lam_h "
                              f"{np.max(lam_h):.2e}")
            if not diff.status.LICQ or np.max(np.abs(du)) > 1e-6:
                faults.append(f"LICQ {diff.status.LICQ}, |du0/dx0| "
                              f"{np.max(np.abs(du)):.2e} (bound 1e-6)")
        check(not faults, f"differentiator, {case}: " + "; ".join(faults))
    return rec


def active_names(mpc, active_sets):
    """The active set as names: (layout key, element) for bounds, the
    inequality row for ``h``."""
    L = mpc.layout
    names = []
    for key in L.offsets:
        for j in range(L.sizes[key]):
            names.append(f"{key}[{j}]")
    return {side: [names[i] if side != "h" else f"h[{i}]"
                   for i in np.nonzero(mask)[0]]
            for side, mask in active_sets.items()}


def differentiator_flagship():
    """Phase 15d at full width (the device of the environment): the
    flagship's du0/dx0 after one make_step from CSTR_X0, with the sizes of
    the dense sensitivity system and the ms of its assembly and solve."""
    import torch
    import dompc_tpu_torch as dm
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    t1 = time.perf_counter()
    mpc.make_step(CSTR_X0)
    step_ms = (time.perf_counter() - t1) * 1e3
    diff = dm.differentiator.DoMPCDifferentiator(mpc)
    solve_ms = []
    real = diff._solve_lse

    def timed(K, rhs):
        _sync(K.device)
        t = time.perf_counter()
        out = real(K, rhs)
        _sync(K.device)
        solve_ms.append((time.perf_counter() - t) * 1e3)
        return out

    diff._solve_lse = timed
    _sync(mpc._device)
    t1 = time.perf_counter()
    du = diff.du0_dx0()
    total_ms = (time.perf_counter() - t1) * 1e3
    return dict(du0_dx0=du.tolist(), K_dim=diff.K_dim, n_opt_x=mpc.n_opt_x,
                n_active=diff.K_dim - mpc.n_opt_x, step_ms=step_ms,
                iters=mpc.solver_stats["iter_count"],
                total_ms=total_ms, solve_ms=solve_ms[0],
                assembly_ms=total_ms - solve_ms[0],
                residuals=diff.status.residuals,
                active=active_names(mpc, diff.active_sets),
                device=str(mpc._device),
                dtype=str(mpc._dtype).replace("torch.", ""))


def differentiator_card_vs_cpu(card, cpu):
    """Phase 15d's yardstick: the flagship's active sets and du0/dx0, card
    against the port on the CPU."""
    flips = {side: sorted(set(card["active"][side])
                          ^ set(cpu["active"][side]))
             for side in card["active"]}
    rel = _rel_max(card["du0_dx0"], cpu["du0_dx0"])
    rec = dict(flipped=flips, du0_dx0_rel=rel, cpu_total_ms=cpu["total_ms"],
               cpu_solve_ms=cpu["solve_ms"], cpu_step_ms=cpu["step_ms"],
               cpu_iters=cpu["iters"], card_iters=card["iters"])
    print("differentiator_card_vs_cpu " + json.dumps(rec), flush=True)
    check(not any(flips.values()),
          f"flagship active sets differ, card vs CPU: {flips}")
    check(rel <= 1e-8, f"flagship du0/dx0 card vs CPU: rel {rel:.2e} "
                       "(bound 1e-8)")
    return rec


def ampc_child():
    """Child process (float32): phase 15 (a-c), then the float64 sampling
    of 15a and its comparison with the float32 one.  It runs beside phases
    11-13; on its own: ``python3 chip_smoke.py --ampc``."""
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    check("DOMPC_TPU_X64" not in os.environ
          and "DOMPC_TPU_PLATFORM" not in os.environ,
          "the approximate-MPC child runs float32 on the card")
    ampc = ampc_phase()
    ampc["f64_sampling"] = ampc_sampling_f64()
    ampc["f32_vs_f64"] = ampc_f32_vs_f64(ampc.pop("U"), ampc.pop("OK"),
                                         ampc["f64_sampling"])
    for key in ("U", "OK"):
        ampc["f64_sampling"].pop(key)
    print("AMPC_RESULT " + json.dumps(ampc), flush=True)


# --------------------------------------------------------------------------
# phase 16: sharded serving, trace capture, OPC UA nodes, host-side modules
# --------------------------------------------------------------------------

def free_port():
    """A TCP port on localhost that is free now (the process group's
    store)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_phase(start):
    """Phase 16a: phase 5's default-backend calls (the flagship at B=128,
    float32, throughput mode, tol 1e-3, the same states and warm start)
    through ``parallel.make_sharded_solver`` over a one-rank NCCL group made
    by ``init_distributed``: n_ok = 128, u0 and iterations equal to phase
    5's, one band_qr launch per Newton step and no tiled launch."""
    import torch
    import torch.distributed as dist
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.parallel import init_distributed, make_sharded_solver

    mpc, x0s, W, cold = (start[k] for k in ("mpc", "x0s", "W", "cold"))
    B = x0s.shape[0]
    check(init_distributed(f"127.0.0.1:{free_port()}", 1, 0),
          "init_distributed returned False")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and torch.cuda.current_device() == mpc._device.index,
              f"process group {dist.get_backend()} on cuda:"
              f"{torch.cuda.current_device()}, MPC on {mpc._device}")
        kw = dict(tol=1e-3, max_iter=60, throughput_mode=True)
        cold_solve, mesh = make_sharded_solver(mpc, **kw)
        warm_solve, _ = make_sharded_solver(mpc, mesh=mesh, warm=True, **kw)
        out = dict(B=B, mesh_size=mesh.size(), calls=[])
        for kind, solve, args, ref in (
                ("cold", cold_solve, (x0s, W), start["calls"][0]),
                ("warm", warm_solve, (x0s * (1.0 + 1e-3), cold.w, cold.lam,
                                      1e-4, cold.zl, cold.zu),
                 start["calls"][1])):
            band_qr.band_solve.launches = 0
            band_qr.band_solve_tiled.launches = 0
            steps0 = solve.solve_batch.ipm.newton_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u0, iters, n_ok = solve(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"band_qr": band_qr.band_solve.launches,
                        "band_sweep_tiled": band_qr.band_solve_tiled.launches}
            steps = solve.solve_batch.ipm.newton_steps - steps0
            u = u0.double().cpu().numpy()
            it = iters.cpu().numpy()
            rel = _rel_max(u, ref["u0"])
            rec = dict(call=kind, wall_s=wall, solves_per_s=B / wall,
                       phase5_solves_per_s=ref["solves_per_s"],
                       n_ok=float(n_ok), iters_mean=float(it.mean()),
                       u0_rel_vs_phase5=rel, newton_steps=steps,
                       launches=launches)
            print("sharded " + json.dumps(rec), flush=True)
            check(u.shape == ref["u0"].shape and it.shape == (B,),
                  f"sharded {kind}: shapes {u.shape}, {it.shape}")
            check(float(n_ok) == B, f"sharded {kind}: n_ok {float(n_ok)} "
                                    f"of {B}")
            check(np.array_equal(it, ref["iters"]),
                  f"sharded {kind}: iterations differ from phase 5's")
            check(rel <= 1e-6, f"sharded {kind}: u0 differs from phase 5's "
                               f"by {rel:.2e} (bound 1e-6)")
            check(launches["band_qr"] == steps > 0
                  and launches["band_sweep_tiled"] == 0,
                  f"sharded {kind}: launches {launches} for {steps} Newton "
                  "steps")
            out["calls"].append(rec)
    finally:
        dist.destroy_process_group()
    return out


def trace_phase(run):
    """Phase 16b: one warm flagship float32 ``make_step`` (phase 4's MPC)
    without the profiler, the next under ``tools.profiler.trace`` into
    build/: the trace holds the step's solve range and as many band_qr
    kernel events as the wrapper counted launches; then
    ``save_device_memory_profile`` writes a non-empty snapshot."""
    import glob
    import pickle
    import shutil
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.tools import profiler

    mpc, x0 = run.pop("mpc"), run.pop("next_x0")
    L = mpc.layout

    def step(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mpc.make_step(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(mpc.solver_stats["success"], "trace phase: a step did not "
                                           "certify")
        nxt = np.asarray(mpc.opt_x_num[L.sl(("x_node", 1, 0))]) \
            * mpc._x_scaling.data
        return ms, mpc.solver_stats["iter_count"], nxt

    plain_ms, plain_iters, x1 = step(x0)
    logdir = os.path.join(ROOT, "build", "trace_smoke")
    shutil.rmtree(logdir, ignore_errors=True)
    band_qr.band_solve.launches = 0
    band_qr.band_solve_tiled.launches = 0
    with profiler.trace(logdir, create_perfetto_trace=True):
        prof_ms, prof_iters, _ = step(x1)
    launches = {"band_qr": band_qr.band_solve.launches,
                "band_sweep_tiled": band_qr.band_solve_tiled.launches}
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    check(len(files) == 1, f"trace files: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    solve_range = f"dompc_tpu_torch.MPC.solve/{mpc._n_solves}"
    check(any(e.get("name") == solve_range for e in events),
          f"the trace holds no range {solve_range}")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    band = [e for e in kernels if "band_qr" in e.get("name", "")]
    kernel_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    out = dict(plain_step_ms=plain_ms, plain_iters=plain_iters,
               profiled_step_ms=prof_ms, profiled_iters=prof_iters,
               launches=launches, band_qr_events=len(band),
               band_qr_event_name=band[0]["name"] if band else None,
               kernel_events=len(kernels), kernel_ms=kernel_ms,
               device_busy_share=kernel_ms / prof_ms,
               band_qr_ms=sum(e.get("dur", 0.0) for e in band) / 1e3,
               trace_mb=os.path.getsize(files[0]) / 2 ** 20)
    mem = os.path.join(logdir, "device_memory.pkl")
    profiler.save_device_memory_profile(mem)
    with open(mem, "rb") as f:
        snap = pickle.load(f)
    out.update(memory_profile_bytes=os.path.getsize(mem),
               memory_segments=len(snap.get("segments", ())))
    print("trace " + json.dumps(out), flush=True)
    check(launches["band_qr"] > 0 and launches["band_sweep_tiled"] == 0,
          f"profiled step: launches {launches}")
    check(len(band) == launches["band_qr"],
          f"the trace holds {len(band)} band_qr kernel events for "
          f"{launches['band_qr']} launches")
    check(out["memory_profile_bytes"] > 0 and out["memory_segments"] > 0,
          "the device-memory snapshot is empty")
    return out


class TagStore:
    """In-memory stand-in for an OPC UA server (tests/test_opcua.py's
    FakeClient): ``client`` is an ``RTBase`` client factory whose clients
    read and write ``tags``."""

    def __init__(self):
        self.tags = {}

    def client(self, opts, namespace):
        store = self

        class Client:
            namespace_list = [namespace]

            def connect(self):
                pass

            def disconnect(self):
                pass

            def writeData(self, tag, value):
                store.tags[tag] = value

            def readData(self, tag):
                return store.tags[tag]
        return Client()


class ServingNode:
    """Phase 8b's converged controller as a node: the flagship's
    ``make_batch_solver(tol=1e-6, max_iter=80)`` on a batch of one, cold at
    the first step and warm-started from its last solution (mu0 1e-4)
    after, behind the MPC's model and settings.  ``MPC.make_step`` is not
    that computation (it moves u_prev and takes one refinement pass), so
    the node wraps the solver the loop it is held to ran."""

    def __init__(self, mpc, solver, w0):
        self.model, self.settings = mpc.model, mpc.settings
        self.solver, self.w0, self.sol = solver, w0, None

    def make_step(self, x0):
        x = np.asarray(x0, dtype=float).reshape(1, -1)
        if self.sol is None:
            self.sol, u = self.solver(x, self.w0)
        else:
            s = self.sol
            self.sol, u = self.solver(x, s.w, s.lam, 1e-4, s.zl, s.zu)
        return u.double().cpu().numpy().reshape(-1, 1)


OPCUA_CYCLES = 2       # node-loop cycles of 16c (phase 8b's first 2 steps)


def _node_cycles(controller):
    """OPCUA_CYCLES cycles of ``controller`` and a fresh ``cstr_simulator``
    from CSTR_X0 as two ``RTBase`` nodes exchanging u and the plant's
    measurements through a :class:`TagStore`: u and x of every cycle, ms
    per node step, and both kernels' launches in each controller step (the
    counts set to 0 just before it and read just after)."""
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.opcua import ClientOpts, RTBase
    from dompc_tpu_torch.systems import cstr_model, cstr_simulator, CSTR_X0

    store = TagStore()
    sim = cstr_simulator(cstr_model())
    sim.x0 = CSTR_X0.copy()
    rt_mpc = RTBase(controller, ClientOpts("mpc", "localhost", 4840),
                    client_factory=store.client)
    rt_sim = RTBase(sim, ClientOpts("sim", "localhost", 4840),
                    client_factory=store.client)
    rt_mpc.def_namespace.namespace_index = 1
    rt_sim.def_namespace.namespace_index = 2
    u_tags = [e.get_node_id(1) for e in rt_mpc.def_namespace.entry_list
              if e.objectnode == "_u"]
    x_tags = [e.get_node_id(2) for e in rt_sim.def_namespace.entry_list
              if e.objectnode == "_y"]
    check(len(u_tags) == 2 and len(x_tags) == 4,
          f"OPC UA tags {u_tags} {x_tags}")
    rt_mpc.set_read_tags(x_tags)
    rt_mpc.set_write_tags(u_tags)
    rt_sim.set_read_tags(u_tags)
    rt_sim.set_write_tags(x_tags)
    rt_sim.write_to_tags(CSTR_X0)
    out = dict(u=[], x=[], mpc_node_ms=[], sim_node_ms=[],
               launches_per_cycle=[], tiled_per_cycle=[])
    for _ in range(OPCUA_CYCLES):
        band_qr.band_solve.launches = 0
        band_qr.band_solve_tiled.launches = 0
        t0 = time.perf_counter()
        rt_mpc.make_step()
        torch.cuda.synchronize()
        out["mpc_node_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches_per_cycle"].append(band_qr.band_solve.launches)
        out["tiled_per_cycle"].append(band_qr.band_solve_tiled.launches)
        t0 = time.perf_counter()
        rt_sim.make_step()
        out["sim_node_ms"].append((time.perf_counter() - t0) * 1e3)
        out["u"].append([store.tags[t] for t in u_tags])
        out["x"].append([store.tags[t] for t in x_tags])
    return out


def _fresh_flagship_mpc():
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0

    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    return mpc


def opcua_loop(res):
    """Phase 16c (float64), OPCUA_CYCLES cycles from CSTR_X0 of two
    ``RTBase`` node loops (:func:`_node_cycles`): phase 8b's converged
    controller (:class:`ServingNode`), u and x equal to 8b's loop, and
    the flagship ``MPC`` itself, ``RTBase(mpc)`` driving ``MPC.make_step``,
    u and x equal to a direct ``mpc.make_step`` / ``sim.make_step`` loop of
    a second MPC built the same way; both 1e-12 relative, band_qr launches
    per cycle and no tiled launch, ms per node step."""
    from dompc_tpu_torch.systems import cstr_model, cstr_simulator, CSTR_X0

    start, ref = res["start"], res["full"]
    serving = _node_cycles(ServingNode(start["mpc"], start["full"],
                                       start["w0"]))
    node = _node_cycles(_fresh_flagship_mpc())
    direct_mpc = _fresh_flagship_mpc()
    sim = cstr_simulator(cstr_model())
    sim.x0 = CSTR_X0.copy()
    x, direct = CSTR_X0.copy(), dict(u=[], x=[])
    for _ in range(OPCUA_CYCLES):
        u = direct_mpc.make_step(x)
        x = np.asarray(sim.make_step(u)).reshape(-1)
        direct["u"].append(u.reshape(-1))
        direct["x"].append(x)
    out = dict(cycles=OPCUA_CYCLES,
               u_rel_vs_8b=_rel_max(serving["u"], ref["u"][:OPCUA_CYCLES]),
               x_rel_vs_8b=_rel_max(serving["x"],
                                    ref["x"][1:OPCUA_CYCLES + 1]),
               **{k: serving[k] for k in (
                   "mpc_node_ms", "sim_node_ms", "launches_per_cycle",
                   "tiled_per_cycle")},
               mpc_node=dict(
                   u_rel_vs_direct=_rel_max(node["u"], direct["u"]),
                   x_rel_vs_direct=_rel_max(node["x"], direct["x"]),
                   **{k: node[k] for k in (
                       "mpc_node_ms", "sim_node_ms", "launches_per_cycle",
                       "tiled_per_cycle")}))
    print("opcua_loop " + json.dumps(out), flush=True)
    nd = out["mpc_node"]
    check(out["u_rel_vs_8b"] <= 1e-12 and out["x_rel_vs_8b"] <= 1e-12,
          f"OPC UA node loop against phase 8b: u {out['u_rel_vs_8b']:.2e}, "
          f"x {out['x_rel_vs_8b']:.2e} (bound 1e-12)")
    check(nd["u_rel_vs_direct"] <= 1e-12 and nd["x_rel_vs_direct"] <= 1e-12,
          f"RTBase(mpc) loop against the direct make_step loop: u "
          f"{nd['u_rel_vs_direct']:.2e}, x {nd['x_rel_vs_direct']:.2e} "
          "(bound 1e-12)")
    for name, loop in (("ServingNode", serving), ("MPC", node)):
        check(all(n > 0 for n in loop["launches_per_cycle"])
              and not any(loop["tiled_per_cycle"]),
              f"OPC UA {name} loop launches {loop['launches_per_cycle']}, "
              f"tiled {loop['tiled_per_cycle']}")
    return out


def host_modules_on_card():
    """Phase 16d (float64): ``sysid.ONNXOperations`` on the 3-5-1 MLP of
    examples/tools/onnx_conversion/onnx_conversion_01.py (its seeded
    weights, the example's input and 63 seeded ones) and
    ``solver.structured``'s band_matvec, band_factor + band_solve and
    band_solve_qr on a seeded (S=21, b=13) band, on the card against the
    same calls on the CPU (1e-12)."""
    import torch
    from dompc_tpu_torch.sysid import ONNXOperations
    from dompc_tpu_torch.solver import structured

    ops = ONNXOperations()
    rng = np.random.default_rng(0)
    W1, b1 = rng.standard_normal((3, 5)), rng.standard_normal(5)
    W2, b2 = rng.standard_normal((5, 1)), rng.standard_normal(1)
    x = np.vstack([np.ones((1, 3)), rng.standard_normal((63, 3))])
    S, b = 21, 13
    D = rng.standard_normal((S, b, b)) + 3.0 * b * np.eye(b)
    U = rng.standard_normal((S - 1, b, b))
    Lo = rng.standard_normal((S - 1, b, b))
    rhs = rng.standard_normal((S, b))

    def run(device):
        def T(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)
        h = ops.Relu(ops.Add(ops.MatMul(T(x), T(W1)), T(b1)))
        y = ops.Add(ops.MatMul(h, T(W2)), T(b2))
        band = [T(a) for a in (D, U, Lo)]
        factors = structured.band_factor(*band)
        outs = dict(mlp=y, matvec=structured.band_matvec(*band, T(rhs)),
                    lu_solve=structured.band_solve(factors, band[1],
                                                   band[2], T(rhs)),
                    qr_solve=structured.band_solve_qr(*band, T(rhs)))
        check(all(v.device.type == torch.device(device).type
                  for v in outs.values()), f"16d outputs not on {device}")
        return {k: v.cpu().numpy() for k, v in outs.items()}

    card, cpu = run("cuda"), run("cpu")
    out = {k: float(np.max(np.abs(card[k] - cpu[k]))
                    / max(1e-300, np.max(np.abs(cpu[k])))) for k in cpu}
    out["lu_vs_qr"] = float(np.max(np.abs(card["lu_solve"]
                                          - card["qr_solve"])))
    print("host_modules " + json.dumps(out), flush=True)
    check(max(out.values()) <= 1e-12,
          f"host-side modules, card against CPU: {out} (bound 1e-12)")
    return out


CHILD_TAGS = {"--main-path-f64": "F64_RESULT ", "--closed-loop-f64":
              "CL_RESULT ", "--mhe-f64": "MHE_RESULT ",
              "--dip-f64": "DIP_RESULT ", "--dip-cpu": "DIPCPU_RESULT ",
              "--dip-f32": "DIP32_RESULT ", "--minlp-f64": "MINLP_RESULT ",
              "--zoo-f64": "ZOO_RESULT ", "--zoo-cpu": "ZOOCPU_RESULT ",
              "--ampc": "AMPC_RESULT "}


def start_child(flag, x64=True, platform=None, sync=None):
    """Start this script with ``flag`` in a child process of its own
    process group (float64 unless ``x64`` is False; on the CPU with
    ``platform="cpu"``; ``sync``: see :func:`dip_wait_turn`)."""
    env = dict(os.environ)
    for var in ("DOMPC_TPU_X64", "DOMPC_TPU_PLATFORM", "DIP_SYNC_DIR"):
        env.pop(var, None)
    if x64:
        env["DOMPC_TPU_X64"] = "1"
    if platform:
        env["DOMPC_TPU_PLATFORM"] = platform
    if sync:
        env["DIP_SYNC_DIR"] = sync
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), flag],
                            env=env, cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, process_group=0)


def stop_child(proc):
    """Kill a child of :func:`start_child` and the processes it started,
    if it is still running."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()


def finish_child(proc, flag, timeout, go=False):
    """Wait for a child of :func:`start_child` (with ``go``, after giving
    it the go of :func:`dip_wait_turn`); echo its lines, fail with its
    errors, return its result line's JSON."""
    try:
        out, err = proc.communicate("go\n" if go else None, timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_child(proc)
        fail(f"{flag} child did not finish in {timeout} s")
    tag = CHILD_TAGS[flag]
    sys.stdout.write("".join(l + "\n" for l in out.splitlines()
                             if not l.startswith(tag)))
    sys.stdout.flush()
    check(proc.returncode == 0, f"{flag} child failed:\n{err[-4000:]}")
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

    def say(what):
        """A phase's heading, with the seconds since the script started."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    # 1. device
    card = card_line()
    print(f"card: {card}", flush=True)

    # 2. build; ptxas's report of every template instance
    say("build:")
    ptxas = {}
    for name, (so, build_s, log) in band_qr.build().items():
        print(f"build: {name}: {so.name} in {build_s:.2f} s", flush=True)
        for rep in band_qr.ptxas_report(log):
            print(f"  ptxas: {json.dumps(rep)}", flush=True)
            ptxas[rep["instance"]] = rep
    for inst in MHE_INSTANCES:
        print(f"  ptxas bucket 97 (MHE, b=83): {json.dumps(ptxas.get(inst))}",
              flush=True)
    for inst in DIP_INSTANCES:
        print(f"  ptxas bucket 32 (DIP, b=23): {json.dumps(ptxas.get(inst))}",
              flush=True)
    for inst in ZOO_INSTANCES:
        print(f"  ptxas buckets 8/16 (LV b=8, bicycle b=15): "
              f"{json.dumps(ptxas.get(inst))}", flush=True)
    if ptxas:   # empty only when build/ already held both libraries
        for inst in FLAGSHIP_INSTANCES:
            rep = ptxas.get(inst)
            check(rep is not None and rep["spill_stores"] == 0
                  and rep["spill_loads"] == 0,
                  f"ptxas: flagship instance {inst} spills or is missing: "
                  f"{rep}")

    # 3. kernels against their plain version
    say("kernels against their plain version:")
    rows = kernel_phase()

    # 4. make_step, float32 here, float64 (and phase 6) in a child process
    # afterwards (one at a time: the host times are the step's own)
    say("make_step float32:")
    run32 = drive_main_path(MAIN_STEPS, f32_settings=True, record=True)
    kkt = check_recorded(run32.pop("recorded"), "band_qr",
                         band_qr.band_solve, "float32 make_step 0")
    # 5. batched serving, float32
    say("batched serving float32, B=128:")
    batched = batched_phase()
    # 7. RTI serving, float32, from phase 5's default-backend solution
    say("RTI serving float32, B=128:")
    rti = rti_phase(batched.pop("rti_start"))
    # 16a and 16b, float32: sharded serving and trace capture
    say("sharded serving float32, B=128, over a one-rank NCCL group:")
    sharded = sharded_phase(batched.pop("shard_start"))
    say("trace capture of a warm make_step float32:")
    traced = trace_phase(run32)
    # 14, float32: the flagship with n_refine_kkt=1 against the default
    say("flagship float32, n_refine_kkt=1 against the default:")
    refine = refine_f32()
    # 13, float32: the scalar MINLP once, recorded without a gate
    say("scalar MINLP float32 (recorded, no gate):")
    minlp32 = minlp_scalar_run("bnb", 1)
    minlp32_rec = dict(minlp32["steps"][0], launches=minlp32["launches"],
                       tiled_launches=minlp32["tiled_launches"],
                       **expansion_summary(minlp32["expansions"]))
    minlp32_rec.pop("w")
    print("minlp_scalar_f32 " + json.dumps(minlp32_rec), flush=True)
    # 4 and 6 (float64), 8, 9, 16c-d, 10 and 13 (float64): four float64
    # children side by side, each mostly host dispatch on a core of its
    # own, with counters of its own; each one's lines are echoed when it
    # ends
    say("make_step float64 and batched float64; closed loop and EKF "
        "float64; MHE and the coupled MHE + MPC loop float64; mixed-integer "
        "MPC float64 (four subprocesses side by side):")
    f64_kids = {flag: start_child(flag) for flag in (
        "--main-path-f64", "--closed-loop-f64", "--mhe-f64", "--minlp-f64")}
    try:
        run64 = finish_child(f64_kids["--main-path-f64"], "--main-path-f64",
                             900)
        main32 = summarize("float32", run32)
        main64 = summarize("float64", run64)
        print("main_path " + json.dumps(main32), flush=True)
        print("main_path " + json.dumps(main64), flush=True)
        say("closed loop and EKF float64 (its lines):")
        loop64 = finish_child(f64_kids["--closed-loop-f64"],
                              "--closed-loop-f64", 600)
        print("closed_loop " + json.dumps(loop64), flush=True)
        say("MHE and the coupled MHE + MPC loop float64 (its lines):")
        mhe64 = finish_child(f64_kids["--mhe-f64"], "--mhe-f64", 600)
        print("mhe_phase " + json.dumps(mhe64), flush=True)
        say("mixed-integer MPC float64 (its lines):")
        minlp = finish_child(f64_kids["--minlp-f64"], "--minlp-f64", 900)
        print("minlp_phase " + json.dumps(minlp), flush=True)
    finally:
        for proc in f64_kids.values():
            stop_child(proc)
    # 11 and 12, the double inverted pendulum in float64 and float32 and
    # the LQR loop; beside them 14's float64 runs on the card (the
    # polymerization's two 150-iteration steps set that child's length)
    # and the CPU yardstick of 13-14
    say("DIP (N=100) float64 and float32, their cold solves side by side "
        "with the CPU yardstick (three subprocesses); beside them the "
        "systems zoo float64 and the differentiator on the card, the CPU "
        "yardstick of phases 13-15 and the approximate-MPC workflow (three "
        "more):")
    zoo_kid = start_child("--zoo-f64")
    zcpu = start_child("--zoo-cpu", platform="cpu")
    # 15 (a-c) and 15a's float64 pass: one more subprocess beside them
    ampc_kid = start_child("--ampc", x64=False)
    try:
        dip = dip_phase(say)
        print("dip_phase " + json.dumps(dip), flush=True)
        say("the systems zoo float64 and the CPU yardstick of phases 13-14:")
        zoo = finish_child(zoo_kid, "--zoo-f64", 900)
        print("zoo_phase " + json.dumps(zoo), flush=True)
        ycpu = finish_child(zcpu, "--zoo-cpu", 900)
        say("approximate MPC (subprocess):")
        ampc = finish_child(ampc_kid, "--ampc", 900)
        print("ampc_phase " + json.dumps(ampc), flush=True)
    finally:
        stop_child(zoo_kid)
        stop_child(zcpu)
        stop_child(ampc_kid)
    zoo_card_vs_cpu(minlp, zoo, ycpu)
    differentiator_card_vs_cpu(zoo["differentiator"]["flagship"],
                               ycpu["differentiator"])
    say("done")

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
    opc = loop64["opcua"]
    for kname, paths in by_path.items():
        cycles = "launches_per_cycle" if kname == "band_qr" \
            else "tiled_per_cycle"
        paths.update({
            "sharded_f32_B128": sum(c["launches"][kname]
                                    for c in sharded["calls"]),
            "profiled_step_f32": traced["launches"][kname],
            "opcua_loop_f64": sum(opc[cycles]),
            "opcua_mpc_node_f64": sum(opc["mpc_node"][cycles]),
            "rti_f32_B128": rti["modes"]["rti"]["launches"][kname],
            "rti_drift_f32_B128": rti["modes"]["rti_drift"]["launches"][kname],
            "closed_loop_f64_full": cl["full_launches"][kname],
            "closed_loop_f64_rti": cl["rti_launches"][kname],
            "mhe_f64_tridiag": mhe["tridiag"]["launches"][kname],
            "mhe_f64_auto_dense": mhe["auto"]["launches"][kname]})
    by_path["band_qr"].update({
        f"coupled_loop_f64_{mod}": n for mod, n in cpl["launches"].items()})
    by_path["band_sweep_tiled"]["coupled_loop_f64"] = cpl["tiled_launches"]
    by_path["band_qr"].update(dip_f64=dip["f64"]["launches"],
                              dip_f32=dip["f32"]["launches"],
                              lqr_f64=dip["lqr"]["launches"]["band_qr"])
    by_path["band_sweep_tiled"].update(
        dip_f64=dip["f64"]["tiled_launches"],
        dip_f32=dip["f32"]["tiled_launches"],
        lqr_f64=dip["lqr"]["launches"]["band_sweep_tiled"])
    for kname, key in (("band_qr", "launches"),
                       ("band_sweep_tiled", "tiled_launches")):
        by_path[kname].update(
            make_step_f32_n_refine_kkt0=refine[0][key],
            make_step_f32_n_refine_kkt1=refine[1][key],
            minlp_scalar_f32=minlp32[key],
            minlp_scalar_f64=minlp["scalar"][key],
            lotka_volterra_f64=minlp["lv"][key],
            flagship_merit_f64=zoo["merit"][key],
            kinematic_bicycle_f64=zoo["kinematic_bicycle"][key],
            kite_f64=zoo["kite"][key],
            industrial_poly_f64=zoo["poly"][key],
            ampc_sampling_f32_B128=ampc["sampling"][key],
            ampc_sampling_f64_B128=ampc["f64_sampling"][key])
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
            # the DIP's chain and its SPIKE solve's two sweeps, row bucket 32
            "dip": {
                f"{r['case']}_{r['dtype']}": {k: r[k] for k in (
                    "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")}
                for r in rows if r["kernel"] == kname
                and r["case"].startswith("dip_")},
            # the chains of phases 13-14 (ZOO_SHAPES)
            "zoo": {
                f"{r['case']}_{r['dtype']}": {k: r[k] for k in (
                    "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")}
                for r in rows if r["kernel"] == kname
                and r["case"] in dict(ZOO_SHAPES)},
            "launches_by_path": by_path[kname],
            # every shape phase 3 holds the kernel at, old and new
            "launch_shapes": {r["case"]: r["shape"] for r in rows
                              if r["kernel"] == kname},
            "ptxas_flagship": [ptxas.get(i) for i in FLAGSHIP_INSTANCES
                               if i.startswith(kname + "<")],
            "ptxas_bucket97": [ptxas.get(i) for i in MHE_INSTANCES
                               if i.startswith(kname + "<")],
            "ptxas_bucket32": [ptxas.get(i) for i in DIP_INSTANCES
                               if i.startswith(kname + "<")],
            "ptxas_bucket8_16": [ptxas.get(i) for i in ZOO_INSTANCES
                                 if i.startswith(kname + "<")],
            "kkt_sweeps": [kkt, run64["kkt"], rti["kkt"],
                           mhe["tridiag"]["kkt"],
                           dip["f64"]["sweeps"]["spike"],
                           dip["f32"]["sweeps"]["spike"], minlp["lv"]["kkt"],
                           ampc["sampling"]["kkt"]]
            if kname == "band_qr" else [batched["kkt"]]})
        if kname == "band_qr":
            # per frontier expansion of branch-and-bound: band_qr launches
            # and the chains of each launch
            kernels[-1]["bnb_expansions"] = {
                path: {k: rec[k] for k in (
                    "expansions", "nodes_per_expansion",
                    "launches_per_expansion",
                    "chains_per_launch", "shapes")}
                for path, rec in (("minlp_scalar_f64", minlp["scalar"]),
                                  ("lotka_volterra_f64", minlp["lv"]),
                                  ("minlp_scalar_f32", minlp32_rec))}
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
    elif sys.argv[1:] == ["--dip-f64"]:
        sys.path.insert(0, ROOT)
        dip_lqr_f64()
    elif sys.argv[1:] == ["--dip-cpu"]:
        sys.path.insert(0, ROOT)
        dip_cpu_f64()
    elif sys.argv[1:] == ["--dip-f32"]:
        sys.path.insert(0, ROOT)
        dip_card_f32()
    elif sys.argv[1:] == ["--minlp-f64"]:
        sys.path.insert(0, ROOT)
        minlp_f64()
    elif sys.argv[1:] == ["--zoo-f64"]:
        sys.path.insert(0, ROOT)
        zoo_f64()
    elif sys.argv[1:] == ["--zoo-cpu"]:
        sys.path.insert(0, ROOT)
        zoo_cpu()
    elif sys.argv[1:] == ["--ampc"]:
        sys.path.insert(0, ROOT)
        ampc_child()
    else:
        main()
