"""Where one warm ``make_step`` (or one warm batched call) of the flagship
spends its time on the card.

    python3 -m dompc_tpu_torch.tools.profile_step [--x64] [--batch B]
        [--out FILE]

Builds the flagship robust CSTR NMPC (N=20, 9 scenarios) on ``cuda``
(float32 with ``solver_tol=1e-4``, 60 iterations; float64 with the default
settings under ``--x64``), takes a cold and two warm steps unprofiled, then
one more warm step under ``torch.profiler``.  With ``--batch B`` the same
is done for ``parallel.make_batch_solver`` on B of bench.py's states
(throughput mode, tol 1e-3, 60 iterations; every warm call starts from the
cold call's solution with x0 moved by 1e-3 and mu0 = 1e-4, so the
profiled call is the warm call chip_smoke.py times;
``DOMPC_TPU_BAND_BACKEND`` picks the band kernel).  Prints, and writes as
JSON to ``--out`` when given:

* the unprofiled warm step's (call's) wall time and iterations (the
  batch's mean and max);
* the profiled step's wall time, the device's busy time (union of the
  kernels' intervals) and its idle share, and the busy time over the
  unprofiled step's wall time where both steps took as many iterations
  (the profiler slows the host, not the kernels);
* kernel launches in the step, and the device time by kernel name (top 15),
  with the band kernels' time and launches;
* host time in the port's spans (``tools/_profiler.py:SPANS``, by name;
  inclusive: ``kkt.solve`` also runs inside ``ipm.step``, ``oracle.point``
  inside the ``ipm.*`` spans, ``sync.<site>`` inside both);
* the card's name and power limit (``nvidia-smi``).

Needs CUDA; exits non-zero without it.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from dompc_tpu_torch.tools._profiler import SPANS

# the prefixes of the port's span names ("batch.", "ipm.", ...)
RANGES = tuple(sorted({name.split(".")[0] + "." for name in SPANS}))


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _flagship(x64):
    from dompc_tpu_torch.systems import cstr_robust_mpc, CSTR_X0
    mpc = cstr_robust_mpc(n_horizon=20, n_robust=1)
    if not x64:
        mpc.settings.solver_tol = 1e-4
        mpc.settings.solver_max_iter = 60
        mpc._create_solver()
    mpc.x0 = CSTR_X0
    mpc.set_initial_guess()
    return mpc


def _step_fn(mpc):
    """One closed-loop make_step per call -> (ms, iterations)."""
    import torch
    from dompc_tpu_torch.systems import CSTR_X0
    L = mpc.layout
    x0 = CSTR_X0.copy()

    def step():
        nonlocal x0
        t0 = time.perf_counter()
        mpc.make_step(x0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        x0 = np.asarray(mpc.opt_x_num[L.sl(("x_node", 1, 0))]) \
            * mpc._x_scaling.data
        return ms, mpc.solver_stats["iter_count"]
    return step


def _batch_fn(mpc, B):
    """One batched call per call -> (ms, (mean iterations, max
    iterations)).  The first call is cold; every later one is the same warm
    call from the cold solution, the warm call that chip_smoke.py times."""
    import torch
    from dompc_tpu_torch.parallel import (make_batch_solver,
                                          initial_guess_from_x0)
    from dompc_tpu_torch.systems import bench_states
    x0s = bench_states(B)
    W = initial_guess_from_x0(mpc, x0s)
    solve = make_batch_solver(mpc, tol=1e-3, max_iter=60,
                              throughput_mode=True)
    cold = None

    def call():
        nonlocal cold
        t0 = time.perf_counter()
        if cold is None:
            sol = cold = solve(x0s, W)[0]
        else:
            sol, _ = solve(x0s * (1.0 + 1e-3), cold.w, cold.lam, 1e-4,
                           cold.zl, cold.zu)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        it = sol.iterations.float()
        return ms, (float(it.mean()), int(it.max()))
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile a batched call of B instances")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.x64:
        os.environ["DOMPC_TPU_X64"] = "1"
    else:
        os.environ.pop("DOMPC_TPU_X64", None)
    os.environ.pop("DOMPC_TPU_PLATFORM", None)
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_step: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile
    from dompc_tpu_torch.solver import band_qr

    dname = "float64" if args.x64 else "float32"
    mpc = _flagship(args.x64)
    step = _batch_fn(mpc, args.batch) if args.batch else _step_fn(mpc)
    step()                       # cold
    step()
    warm_ms, warm_iters = step()
    band = {"band_qr": band_qr.band_solve,
            "band_sweep_tiled": band_qr.band_solve_tiled}
    launches0 = {k: fn.launches for k, fn in band.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms, prof_iters = step()
    band_launches = {k: fn.launches - launches0[k] for k, fn in band.items()}

    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(RANGES)]
    ranges = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(RANGES):
            key = e.name.split("/")[0]
            d = ranges.setdefault(key, [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.end - e.time_range.start
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    band_us = {k: sum(v[1] for name, v in by_name.items() if k in name)
               for k in band}
    rec = dict(
        card=_card(), dtype=dname, batch=args.batch or None,
        warm_step_ms=warm_ms, warm_step_iters=warm_iters,
        profiled_step_ms=prof_ms, profiled_step_iters=prof_iters,
        kernel_launches=len(kernels), band_launches=band_launches,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / 1e3 / prof_ms) if kernels
        else None,
        busy_share_of_unprofiled_step=(busy_us / 1e3 / warm_ms)
        if kernels and warm_iters == prof_iters else None,
        band_device_ms={k: v / 1e3 for k, v in band_us.items()},
        host_ranges={k: dict(count=v[0], ms=v[1] / 1e3)
                     for k, v in sorted(ranges.items())},
        top_kernels=[dict(name=k[:90], count=v[0], device_ms=v[1] / 1e3)
                     for k, v in top])
    if args.batch:
        rec["solves_per_s_unprofiled"] = args.batch / (warm_ms / 1e3)
    if not kernels:
        rec["note"] = "torch.profiler recorded no device events"
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "top_kernels"}))
    for t in rec["top_kernels"]:
        print(f"  {t['device_ms']:9.3f} ms {t['count']:6d}x  {t['name']}")


if __name__ == "__main__":
    main()
