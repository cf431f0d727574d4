"""Captured CUDA graphs of the IPM's point evaluations and of the
structured KKT backends' derivative oracles.

A point evaluation (f, g, h, grad f, the Jacobian or Hessian products at
one point) dispatches the same few hundred small kernels at every call
whose arguments have the same shapes: the batch is always full, and
finished elements are frozen by ``torch.where``, not dropped.  So do the
derivative oracles of ``kkt.prepare`` (the instance gather, Hessians and
Jacobians, ``controller/_mpc.py:_prepare_fn``), once a Newton step, in
thousands of kernels.  :class:`GraphCache` captures such an evaluation
once as a ``torch.cuda.CUDAGraph`` and replays it from then on, so the
host launches one graph where it dispatched every operator.

The policy reads only what a call can observe:

* eager whenever an argument is not a tensor or not on the cache's device
  type (CUDA; so the CPU always), autograd records through an argument, or
  a ``torch.func`` transform is active;
* the first call of a key (the function, and every argument's shape, dtype
  and device) runs eagerly: it is the warm-up (lazy constants, cuBLAS);
* the second captures the graph on a side stream and replays it at once
  (captured kernels do not run), with Python's garbage collector paused: a
  collection inside the capture would destroy the graphs of solvers no
  longer referenced, which CUDA forbids while a stream captures (the
  capture then fails); ``torch.cuda.graph`` collects before capturing for
  the same reason;
* every later call copies the arguments into the graph's static inputs,
  replays it, and returns clones of the static outputs: a caller keeps its
  results across later evaluations, which a replay overwrites in place;
* a capture that raises sends its key back to eager for good.

The graphs of one cache share one memory pool; they replay one at a time
on one stream, and every output is cloned before the next replay, so no
graph reads what another wrote.  A capture that fails (an operation not
allowed while a stream captures, such as a host read) is ended, its pool
is left to what it already holds, and later captures take a new one.
Each kind of evaluation counts apart and replays in a span of its own
(:data:`KINDS`): the point evaluations in ``tools/_profiler.py:
oracle_graph`` and span ``oracle.replay``, the derivative oracles in
``prepare_graph`` and span ``kkt.replay``.  A solver and its structured
backend evaluate through one cache (``Optimizer._make_solver`` makes it),
so both kinds share its pool.
"""
from __future__ import annotations

import gc

import torch
from torch.utils import _pytree as pytree

from ..tools import _profiler as profiler

_ONCE = object()     # seen once, eagerly: capture at the next sight
_EAGER = object()    # its capture failed: eager for good

# kind of evaluation -> (its counters, the span a replay runs in)
KINDS = {"point": (profiler.oracle_graph, "oracle.replay"),
         "prepare": (profiler.prepare_graph, "kkt.replay")}


class _Graph:
    """One captured evaluation: ``run(args)`` copies ``args`` into the
    static inputs, replays, and returns clones of the static outputs."""

    def __init__(self, replay, inputs, outputs):
        self.replay = replay
        self.inputs = inputs
        self.leaves, self.spec = pytree.tree_flatten(outputs)
        if not all(isinstance(x, torch.Tensor) for x in self.leaves):
            raise TypeError("a captured evaluation returns tensors only")

    def outputs(self):
        return pytree.tree_unflatten([x.clone() for x in self.leaves],
                                     self.spec)

    def run(self, args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.replay()
        return self.outputs()


class GraphCache:
    """Replays the evaluations ``cache(fn, args, kind)`` of ``fn(*args)``
    as captured graphs, by the policy of the module, for arguments on
    ``device_type``; ``kind`` (of :data:`KINDS`) names the counters and
    the replay span.

    ``capture(fn, static_args) -> (replay, static_outputs)`` replaces the
    CUDA graph capture (tests drive the policy on the CPU through it)."""

    def __init__(self, capture=None, device_type="cuda"):
        self._capture = capture if capture is not None else self._cuda
        self._device_type = device_type
        self._keys = {}
        self._pool = self._stream = None

    def _eligible(self, args):
        if not args:
            return False
        for a in args:
            if not isinstance(a, torch.Tensor) \
                    or a.device.type != self._device_type:
                return False
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return False
        return torch._C._functorch.maybe_current_level() is None

    def _cuda(self, fn, static_args):
        """Capture ``fn(*static_args)`` into one graph of this cache's pool,
        on its side stream, on the arguments' device."""
        with torch.cuda.device(static_args[0].device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream()
            graph = torch.cuda.CUDAGraph()
            self._stream.wait_stream(torch.cuda.current_stream())
            try:
                with torch.cuda.stream(self._stream):
                    graph.capture_begin(self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(*static_args)
                    finally:
                        graph.capture_end()
            except Exception:
                self._pool = None
                raise
            finally:
                torch.cuda.current_stream().wait_stream(self._stream)
        return graph.replay, out

    def __call__(self, fn, args, kind="point"):
        counts, replay_span = KINDS[kind]
        if not self._eligible(args):
            counts.eager += 1
            return fn(*args)
        key = (fn,) + tuple((a.shape, a.dtype, a.device) for a in args)
        entry = self._keys.get(key)
        if isinstance(entry, _Graph):
            counts.replays += 1
            with profiler.span(replay_span):
                return entry.run(args)
        if entry is _ONCE:
            inputs = [a.clone(memory_format=torch.contiguous_format)
                      for a in args]
            collecting = gc.isenabled()
            gc.disable()
            try:
                replay, outputs = self._capture(fn, inputs)
                graph = _Graph(replay, inputs, outputs)
            except Exception:
                self._keys[key] = _EAGER
                counts.failures += 1
            else:
                self._keys[key] = graph
                counts.captures += 1
                graph.replay()
                return graph.outputs()
            finally:
                if collecting:
                    gc.enable()
        elif entry is None:
            self._keys[key] = _ONCE
        counts.eager += 1
        return fn(*args)
