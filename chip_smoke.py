"""Smoke run of the PyTorch port (dompc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: the band-QR kernel from dompc_tpu_torch/csrc/band_qr.cu (nvcc,
   sm_90a), with the build seconds and ptxas's register/spill report;
3. kernel against its plain twin, float32 and float64, at the flagship
   shape (9 chains, S=21, b=13, t=12), a batch of 128 flagship problems
   (1152 chains), the DIP chain length S=101, and 1e22 diagonal entries in
   float32; relative error against the twin, operator residual, and the
   kernel's, twin's and torch.linalg.solve's (dense yardstick) times;
4. main path: the flagship robust CSTR NMPC (N=20, 9 scenarios) through
   Model -> MPC.setup() -> set_initial_guess() -> 5 make_step calls on the
   card, in float32 (solver_tol 1e-4, 60 iterations) and in float64 (in a
   subprocess with DOMPC_TPU_X64=1), with the launch counter reset just
   before and read just after; the float64 pass also solves step 1 with the
   port on the CPU and holds the card's u0 to it.  The band sweeps of
   float32 step 0 are recorded and the kernel is held against its twin on
   those real KKT chains too.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists the kernels, and the one before that names the card and its power
limit.  Needs CUDA; exits non-zero without it.
"""
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
    import torch
    from dompc_tpu_torch.solver import band_qr
    from dompc_tpu_torch.solver.bbd import band_matvec

    rows = []
    for dname, cases in BAND_CASES.items():
        dt = getattr(torch, dname)
        for seed, (name, shape, huge, rel_max, res_max) in enumerate(cases):
            N, S, b, t = shape
            D, U, Lo, rhs = [torch.as_tensor(a, dtype=dt, device="cuda")
                             for a in band_case(*shape, seed, huge)]
            x = band_qr.band_solve(D, U, Lo, rhs)
            torch.cuda.synchronize()
            # the twin's reference runs on a CPU copy of the same inputs:
            # on the card its batched torch.linalg.qr overflows in float32
            # on a 1e22 diagonal and returns NaN (measured on the H100),
            # while LAPACK's Householder norm is scaled like the kernel's
            ref = band_qr.band_solve_qr_multi(
                *[a.cpu() for a in (D, U, Lo, rhs)])
            err = float((x.cpu() - ref).abs().max())
            rel = err / float(ref.abs().max())
            res = float((band_matvec(D, U, Lo, x) - rhs).abs().max()
                        / rhs.abs().max())
            ok = bool(torch.isfinite(x).all()) and rel <= rel_max \
                and res <= res_max
            reps = 20 if N * S < 5000 else 5
            ms = cuda_ms(lambda: band_qr.band_solve(D, U, Lo, rhs), reps)
            plain_ms = cuda_ms(
                lambda: band_qr.band_solve_qr_multi(D, U, Lo, rhs), 3)
            A = dense_chain(D, U, Lo)
            B = rhs.reshape(N, S * b, t)
            lib_ms = cuda_ms(lambda: torch.linalg.solve(A, B), 3)
            del A, B
            nbytes, flops = band_work(N, S, b, t, x.element_size())
            bound = max(nbytes / MEM_BW, flops / PEAK[dname]) * 1e3
            row = dict(case=name, dtype=dname, shape=list(shape),
                       max_abs_err=err, rel_err=rel, rel_bound=rel_max,
                       residual=res, residual_bound=res_max, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by="bytes" if nbytes / MEM_BW
                       >= flops / PEAK[dname] else "operations",
                       bytes=nbytes, flops=flops, ok=ok)
            print("band_qr " + json.dumps(row), flush=True)
            rows.append(row)
            check(ok, f"band_qr {dname} {name}: rel {rel:.2e} (bound "
                      f"{rel_max:g}), residual {res:.2e} (bound {res_max:g})")
    return rows


# --------------------------------------------------------------------------
# phase 4: main path
# --------------------------------------------------------------------------

def drive_main_path(n_steps, f32_settings, record=False):
    """Flagship robust CSTR on the card: returns the steps' records.  The
    launch counter is zeroed just before the steps.  With ``record``, the
    inputs of every band sweep of step 0 are kept (copies on the card) for
    :func:`check_recorded`; step 0's time then includes the copies."""
    from dompc_tpu_torch.solver import band_qr, bbd
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

    def recording(D, U, Lo, rhs):
        recorded.append([a.clone() for a in (D, U, Lo, rhs)])
        return band_qr.band_solve(D, U, Lo, rhs)

    band_qr.band_solve.launches = 0
    for k in range(n_steps):
        bbd.band_solve = recording if record and k == 0 \
            else band_qr.band_solve
        t1 = time.perf_counter()
        try:
            u0 = mpc.make_step(x0).reshape(-1)
        finally:
            bbd.band_solve = band_qr.band_solve
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
    launches = band_qr.band_solve.launches
    check(launches > 0, "the main path launched no band_qr kernel")
    return dict(setup_s=setup_s, steps=steps, launches=launches,
                first_state=first_state, recorded=recorded)


# The sweeps of a real step are barrier-scaled KKT chains: ill-conditioned,
# with diagonals up to ~1e22 in float32, so neither solver is accurate to
# float32 roundoff there.  The kernel is held to its twin's own accuracy on
# the same float32 inputs: its residual and its error against the float64
# twin within KKT_FACTOR times the twin's, plus KKT_FLOOR (~10 float32 eps)
# for inputs where the twin is exact to roundoff.
KKT_FACTOR, KKT_FLOOR = 10.0, 1e-6


def check_recorded(recorded):
    """Kernel against twin on the band sweeps recorded in float32 step 0.
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
        x_k = band_qr.band_solve(*args).cpu().double()
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
              f"band_qr on recorded KKT sweep {i}: {row} (bound: "
              f"{KKT_FACTOR:g} x twin + {KKT_FLOOR:g})")
    worst["sweeps"] = len(recorded)
    check(worst["sweeps"] > worst["non_finite_inputs"],
          "no band sweep of float32 step 0 had finite inputs")
    print("band_qr_kkt " + json.dumps(worst), flush=True)
    return worst


def main_path_f64():
    """Child process (DOMPC_TPU_X64=1): 5 float64 steps on the card, then
    step 1 again with the port on the CPU from the same state."""
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
    print("F64_RESULT " + json.dumps(run), flush=True)


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
    for var in ("DOMPC_TPU_PLATFORM", "DOMPC_TPU_X64"):
        os.environ.pop(var, None)
    t_start = time.perf_counter()

    # 1. device
    card = card_line()
    print(f"card: {card}", flush=True)

    # 2. build
    so, build_s, log = band_qr.build()
    print(f"build: {so.name} in {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernel against twin
    rows = kernel_phase()

    # 4. main path, float32 here, float64 in a child process
    print("main path float32:", flush=True)
    run32 = drive_main_path(5, f32_settings=True, record=True)
    kkt = check_recorded(run32.pop("recorded"))
    env = dict(os.environ, DOMPC_TPU_X64="1")
    print("main path float64:", flush=True)
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--main-path-f64"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    sys.stdout.write("".join(l + "\n" for l in child.stdout.splitlines()
                             if not l.startswith("F64_RESULT ")))
    check(child.returncode == 0,
          f"float64 main path failed:\n{child.stderr[-4000:]}")
    run64 = json.loads(next(l for l in child.stdout.splitlines()
                            if l.startswith("F64_RESULT "))[11:])
    main32, main64 = summarize("float32", run32), summarize("float64", run64)
    print("main_path " + json.dumps(main32), flush=True)
    print("main_path " + json.dumps(main64), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    flag = next(r for r in rows
                if r["case"] == "flagship" and r["dtype"] == "float32")
    kernels = [{
        "name": "band_qr", "route": "cuda",
        "source": "dompc_tpu_torch/csrc/band_qr.cu",
        "replaces": "dompc_tpu/solver/pallas_band.py:244",
        "launches": run32["launches"], "max_abs_err": flag["max_abs_err"],
        "ms": flag["ms"], "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"], "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"], "kkt_sweeps": kkt}]
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
