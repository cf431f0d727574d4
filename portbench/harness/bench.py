"""Run one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up builds the configuration's MPC and ``make_batch_solver`` on the
card and makes the solves its traffic needs before the window (the
traffic mode's ``setup``: a fleet's cold start, one untimed call).  The
window then calls ``solve_batch`` through the mode back to back in one
closed loop for ``--seconds``: each call waits for every u0 on the host
before the next states are handed over.  With ``--trace 1`` the first
``trace_calls`` calls of the window run under ``torch.profiler`` and the
cell's per-layer metrics are reported instead of its end-to-end ones.

After the window the peak memory is read, the program is freed, and the
reference judges the answers of ``check_calls`` calls drawn from the seed
(:mod:`portbench.harness.check`).  The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.  Exits non-zero,
printing no result, without a card, or if JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import check, registry
from .trace import CALL_SPAN, BandRecorder, from_profiler
from .traffic import StateStream

FORBIDDEN = ("jax", "jaxlib", "flax", "dompc_tpu")
_T0 = time.monotonic()


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def process_age_s():
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dirs():
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's band kernels already build into ``build/``)."""
    build = registry.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _ok_mask(u0, success, lo, hi, us):
    """Certified, finite and inside the input bounds (to the rounding of
    u0 = w * scaling in the program's dtype: 2**-20 of the bound's size
    plus the scaling)."""
    slack = 2.0 ** -20 * (np.abs(np.where(np.isfinite(lo), lo, 0))
                          + np.abs(np.where(np.isfinite(hi), hi, 0)) + us)
    fin = np.isfinite(u0).all(1)
    inside = ((u0 >= lo - slack) & (u0 <= hi + slack)).all(1)
    return success.astype(bool) & fin & inside


def run_cell(cell, seed, seconds, trace, *, cpu=False, batch=None,
             n_horizon=None, program_hook=None, log=None):
    """Run ``cell`` and return ``(result, compared)``: the result line as
    a dict and the compared numbers as (name, value, limit) rows.

    ``cpu``, ``batch``, ``n_horizon`` and ``program_hook`` (a function
    given the built program, to plant a fault or the control) serve the
    tests and the control; a benchmark run passes none of them."""
    log = log or (lambda rec: print(json.dumps(rec), flush=True))
    cfg = cell.cfg
    traffic = dict(cell.traffic)
    if batch is not None:
        traffic["batch"] = batch
    from .program import Program, select_device
    select_device(cfg, cpu=cpu)
    import torch
    if not cpu and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        raise NoDevice(
            f"cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    ref = cell.reference()
    from ..reference.ocp import Transcription
    ocp = dict(cfg["ocp"])
    if n_horizon is not None:
        ocp["n_horizon"] = n_horizon
    tr = Transcription(ocp, ref)
    lo = tr.lb[tr.u0_idx] * tr.us
    hi = tr.ub[tr.u0_idx] * tr.us
    stream = StateStream(traffic, cfg["x_nominal"], seed)
    mode = registry.mode(traffic["mode"])
    B = int(traffic["batch"])

    prog = Program(cfg, n_horizon=n_horizon)
    if program_hook is not None:
        program_hook(prog)
    recorder = BandRecorder() if trace else None
    if recorder:
        recorder.install()

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    # ---- set-up: the solves the traffic needs before its window ----
    run = SimpleNamespace(prog=prog, stream=stream, traffic=traffic)
    setup_info = mode.setup(run)
    sync()
    setup_s = process_age_s()

    # ---- the window ----
    n_trace = int(traffic["trace_calls"]) if trace else 0
    n_check = int(traffic["check_calls"])
    pick = np.random.default_rng([int(seed), 1])
    retained = []
    calls = []
    prof = None
    record = torch.profiler.record_function
    t_first = None
    while True:
        i = len(calls)
        if i == 0 and n_trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if not cpu:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            recorder.active = True
        x = mode.states(run)
        steps0 = prog.newton_steps()
        t0 = time.perf_counter()
        with record(CALL_SPAN):
            sol, u0 = mode.call(run, x)
            u0h = u0.cpu().numpy().astype(np.float64)
            success = sol.success.cpu().numpy()
        t1 = time.perf_counter()
        if t_first is None:
            t_first = t0
        ok = _ok_mask(u0h, success, lo, hi, tr.us)
        calls.append(dict(t0=t0, t1=t1, steps=prog.newton_steps() - steps0,
                          attempted=B, certified=int(ok.sum())))
        if i + 1 == n_trace:
            sync()
            prof.stop()
            recorder.active = False
        keep = dict(x0s=x, u0=u0h, ok=ok, w=sol.w, s=sol.s, lam=sol.lam,
                    zl=sol.zl, zu=sol.zu)
        if i < n_check:
            retained.append(keep)
        else:
            j = int(pick.integers(0, i + 1))
            if j < n_check:
                retained[j] = keep
        sol = u0 = keep = None
        if t1 - t_first >= seconds and len(calls) >= max(n_trace, 1):
            break

    peak = int(torch.cuda.max_memory_allocated()) if not cpu else 0
    tracing = from_profiler(prof) if prof is not None else None
    if recorder:
        recorder.remove()
    prof = None
    run = prog = None
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()

    # ---- correctness: the reference judges the retained answers ----
    attempted = sum(c["attempted"] for c in calls)
    failed = attempted - sum(c["certified"] for c in calls)
    numbers = check.judge(tr, retained, float(cfg.get("kkt_s_max", 100.0)))
    numbers["uncertified_share"] = failed / attempted
    retained = None
    correct, compared = check.verdict(numbers, cell.limits)

    # what the metric readers read
    ctx = SimpleNamespace(calls=calls, traced=calls[:n_trace], trace=tracing,
                  band_shapes=recorder.shapes if recorder else [],
                  setup_s=setup_s, window_s=calls[-1]["t1"] - t_first)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cpu:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if tracing is not None:
        device["busy_s"] = tracing.busy_ns() / 1e9
        device["window_s"] = tracing.window_ns / 1e9
        result["breakdown"] = {"device_ops": tracing.top_device_ops(),
                               "idle_gaps": tracing.idle_gaps()}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}

    periods = np.array([c["t1"] - c["t0"] for c in calls]) * 1e3
    steps = np.array([c["steps"] for c in calls])
    log({"cell": cell.name, "seed": int(seed), "trace": int(bool(trace)),
         "setup": setup_info, "setup_s": setup_s, "calls": len(calls),
         "batch": B, "window_s": ctx.window_s,
         "call_ms": {"median": float(np.median(periods)),
                     "p90": float(np.percentile(periods, 90)),
                     "min": float(periods.min()),
                     "max": float(periods.max())},
         "newton_steps": {"mean": float(steps.mean()),
                          "min": int(steps.min()), "max": int(steps.max())},
         "memory_peak_bytes": peak, "band_launches_traced":
         len(recorder.shapes) if recorder else None})
    return result, compared


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    try:
        bench = registry.load_benchmark()
        cell = registry.Cell(bench, args.workload)
        result, compared = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace))
    except NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, value, limit in compared:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
