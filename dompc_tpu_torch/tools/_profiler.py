"""``torch.profiler`` integration: tracing hooks for solves (counterpart of
the JAX package's ``jax.profiler`` hooks).

The hot calls (MPC/MHE solves) run under named ranges that show on the
profiler timeline, and a trace of any block can be captured::

    with dm.tools.profiler.trace("build/trace"):
        mpc.make_step(x0)        # range dompc_tpu_torch.MPC.solve/<n>
    # -> build/trace/<host>_<pid>.<ms>.pt.trace.json (Chrome / Perfetto)

A ``record_function`` range costs next to nothing when no profiler is
active, so the annotations stay on the hot path.  One trace runs at a time
in a process, as with ``jax.profiler``.
"""
import contextlib
import os
import pickle
import socket
import time

import torch

from .._config import resolve_device

_active = {}     # the running trace: {"prof": profile, "logdir": str}


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
