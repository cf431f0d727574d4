"""``torch.profiler`` integration: tracing hooks for solves (counterpart of
the JAX package's ``jax.profiler`` hooks).

The hot calls (MPC/MHE solves) run under named ranges that show on the
profiler timeline, and a trace of any block can be captured::

    with dm.tools.profiler.trace("build/trace"):
        mpc.make_step(x0)        # range dompc_tpu_torch.MPC.solve/<n>
    # -> build/trace/<host>_<pid>.<ms>.pt.trace.json (Chrome / Perfetto)

Inside the solve the port opens the spans of :data:`SPANS` through
:func:`span`, a ``record_function`` range while a profiler records and one
shared no-op context otherwise, so they stay on the hot path.  Every
blocking read of the device on the solve path opens a ``sync.<site>``
span through :func:`host_sync` (and :func:`any_true`,
:func:`to_device`), which also counts it in ``host_sync.count``; the
point evaluations' CUDA graphs count in :data:`oracle_graph`, the
derivative oracles' in :data:`prepare_graph`.  One
trace runs at a time in a process, as with ``jax.profiler``.
"""
import contextlib
import os
import pickle
import socket
import time
import types

import torch

from .._config import resolve_device

_active = {}     # the running trace: {"prof": profile, "logdir": str}

# Every span the port opens, with its layer and what it covers.  The spans
# nest as the layers do: ``batch.solve`` > ``ipm.*`` > ``kkt.*`` /
# ``oracle.*`` > ``sync.*``.  The benchmark's readers
# (``portbench/metrics``) and ``tools/profile_step.py`` read these names.
SPANS = {
    "dompc_tpu_torch.MPC.solve/<n>": "controller: one MPC.solve",
    "dompc_tpu_torch.MHE.solve/<n>": "estimator: one MHE.solve",
    "dompc_tpu_torch.Simulator.simulate": "simulator: one integration",
    "batch.solve": "batched entry (parallel/batch.py): one solving call "
                   "(with chunk, one sub-batch): x0 into pvec, the inputs' "
                   "conversions, the IPM, u0",
    "ipm.init": "IPM edges (solver/ipm.py): init_state and the "
                "cold_dual_init estimate",
    "ipm.evals": "IPM loop: a pass's point evaluations, residuals and "
                 "convergence test",
    "ipm.step": "IPM loop: one globalized Newton step",
    "ipm.newton": "IPM loop: the Newton direction (KKT prepare and solves, "
                  "the ladder, refinement)",
    "ipm.line_search": "IPM loop: full-step acceptance (filter or l1 merit), "
                       "KKT-decrease test, SOC, backtracking, restoration, "
                       "to the chosen step size",
    "ipm.rti": "IPM loop: the fixed real-time-iteration steps",
    "ipm.rti_drift": "IPM loop: RTI drift corrections",
    "ipm.polish": "IPM edges: the active-set Newton polish",
    "ipm.finish": "IPM edges: after the loop, the watchdog selection, the "
                  "final KKT error, the polish selection, f(w)",
    "oracle.point": "IPM point evaluations (solver/ipm.py): f, g, h, grad f "
                    "and Jacobian products at one point; never nested",
    "oracle.replay": "inside oracle.point: the evaluation replayed as a "
                     "captured CUDA graph (solver/_graphs.py): arguments "
                     "copied in, the replay, outputs cloned",
    "oracle.gather": "derivative oracles (controller/_mpc.py): the instance "
                     "inputs gathered from (w, pvec)",
    "oracle.hessian": "derivative oracles: vmap(d2_lag) with the instance "
                      "multipliers",
    "oracle.jacobian": "derivative oracles: vmap(d_g) and vmap(d_h)",
    "kkt.replay": "inside oracle.gather, oracle.hessian or oracle.jacobian: "
                  "the derivative oracle replayed as a captured CUDA graph "
                  "(solver/_graphs.py): arguments copied in, the replay, "
                  "outputs cloned",
    "kkt.prepare": "KKT: derivatives and assembly, once a Newton step",
    "kkt.solve": "KKT: one right-hand side solved",
    "kkt.condense": "condensed KKT (controller/_mpc.py): the per-instance "
                    "Schur elimination of the interiors",
    "kkt.assemble": "KKT: band blocks, border and right-hand side packed",
    "kkt.bbd_solve": "BBD solve (solver/bbd.py): band sweep, root Schur "
                     "complement, refinement",
    "kkt.refine": "BBD solve: one refinement pass inside kkt.bbd_solve, the "
                  "residual's bbd_matvec and its re-solve (the KKT "
                  "backends take none in float32)",
    "kkt.expand": "condensed KKT: unpacking and the interior "
                  "back-substitution",
    # host-device boundary: one span a blocking read of the device, named by
    # its site; the span's length is the host's wait for the card
    "sync.loop": "solver_loop: does an element still iterate",
    "sync.live": "body: does an unconverged element take a step",
    "sync.ladder": "the regularization ladder: does a step need a rung",
    "sync.kkt_decrease": "take_step: does an element need the KKT-decrease "
                         "test",
    "sync.soc": "take_step: does an element need a second-order correction",
    "sync.line_search": "the filter or l1-merit backtracking loop",
    "sync.resto": "take_step: does an element need restoration",
    "sync.resto_search": "restoration's backtracking loop",
    "sync.rti_drift": "the RTI drift loop",
    "sync.dual_init": "cold_dual_init: is an element cold",
    "sync.debug": "IPMSettings.debug: a diagnostic line's values",
    "sync.w0": "a host primal start copied to the device",
    "sync.p": "host parameters copied to the device",
    "sync.x0": "host initial states copied to the device",
    "sync.lam0": "host multipliers copied to the device",
    "sync.mu0": "a host barrier parameter copied to the device",
    "sync.zl0": "host lower bound duals copied to the device",
    "sync.zu0": "host upper bound duals copied to the device",
    "sync.bounds": "host per-solve bounds copied to the device",
    "sync.delta": "a host regularization copied to the device",
}

_NOOP = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name):
    """The port's named range ``name`` (one of :data:`SPANS`): a
    ``torch.profiler.record_function`` while a profiler records, on the
    profiler's clock beside the device's events, and otherwise one shared
    no-op context, which records nothing and calls no dispatcher.  Open
    spans around ``torch.func`` transforms, never inside them."""
    return torch.profiler.record_function(name) if _recording() else _NOOP


def host_sync(site):
    """Span ``sync.<site>`` around one blocking read of the device (the host
    waits there until the card has drained its queue); counts the read in
    ``host_sync.count``."""
    host_sync.count += 1
    return span("sync." + site)


host_sync.count = 0

# The point evaluations' CUDA graphs (solver/_graphs.py): keys captured,
# evaluations replayed, evaluations run eagerly (the CPU, a key's first
# sight, autograd or torch.func, a failed capture) and failed captures.
oracle_graph = types.SimpleNamespace(captures=0, replays=0, eager=0,
                                     failures=0)
# The same for the derivative oracles of kkt.prepare (controller/_mpc.py:
# the instance gather, Hessians and Jacobians), which the structured KKT
# backends evaluate through the solver's cache.
prepare_graph = types.SimpleNamespace(captures=0, replays=0, eager=0,
                                      failures=0)


def any_true(site, pred):
    """``bool(pred.any())``: the reduction is queued, then its value read in
    span ``sync.<site>``."""
    flag = torch.as_tensor(pred).any()
    with host_sync(site):
        return bool(flag)


def to_device(site, x, dtype, device):
    """``x`` as a tensor of ``dtype`` on ``device``.  A tensor already on a
    device of that type is moved and cast there; anything else is copied
    from the host, which on the card waits for the queue to drain: span
    ``sync.<site>``."""
    if torch.is_tensor(x) and x.device.type == device.type:
        return x.to(device=device, dtype=dtype)
    with host_sync(site):
        return torch.as_tensor(x, dtype=dtype, device=device)


def start_trace(logdir, create_perfetto_link=False,
                create_perfetto_trace=False):
    """Begin a profiler trace of the host (CPU activities) and, when the
    device is CUDA, of the card's kernels (CUDA activities, CUPTI).
    :func:`stop_trace` writes it into ``logdir`` as a Chrome/Perfetto JSON,
    which is what ``create_perfetto_trace=True`` asks for;
    ``create_perfetto_link=True`` needs a trace server and raises."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link needs a Perfetto trace "
                         "server; open the JSON written into logdir in "
                         "ui.perfetto.dev or chrome://tracing instead")
    if _active:
        raise RuntimeError("a profiler trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device().type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active.update(prof=prof, logdir=str(logdir))


def stop_trace():
    """End the trace of :func:`start_trace` and write it; returns the path
    of the trace file.  Raises when no trace is running."""
    if not _active:
        raise RuntimeError("no profiler trace is running")
    prof, logdir = _active.pop("prof"), _active.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir, **kwargs):
    """Context manager capturing a profiler trace of the enclosed block."""
    start_trace(logdir, **kwargs)
    try:
        yield
    finally:
        stop_trace()


def annotate(name):
    """Named range for a code region on the profiler timeline."""
    return torch.profiler.record_function(name)


def step_annotation(name, step_num):
    """Named range ``<name>/<step_num>`` on the profiler timeline (the
    step-structured annotation of iterative solve loops)."""
    return torch.profiler.record_function(f"{name}/{int(step_num)}")


def save_device_memory_profile(path):
    """Dump the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``: segments, blocks and, when memory
    history is recorded, the allocation stacks) as a pickle, loadable in
    pytorch.org/memory_viz; the JAX package writes a pprof profile of HBM.
    Raises on the CPU, where torch keeps no device-memory profile."""
    device = resolve_device()
    if device.type != "cuda":
        raise RuntimeError("no device-memory profile on the CPU: torch "
                           "records one for CUDA devices only")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(device), f)
