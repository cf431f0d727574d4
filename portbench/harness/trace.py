"""The traced window: ``torch.profiler`` over a few calls, reduced to the
numbers the per-layer readers take.

The arithmetic is a copy of the program's ``tools/profile_step.py`` (the
union of the device operations' intervals gives the busy time), extended
with the self time of nested host ranges and the idle gaps between device
operations named by the host range they fall in.  Times are nanoseconds
on the profiler's clock, which it shares between host and device events.
"""
from __future__ import annotations

import bisect

CALL_SPAN = "portbench.call"
BAND_KERNELS = ("band_qr_kernel", "band_qr_wide_kernel",
                "band_sweep_tiled_kernel")
_NOT_KERNELS = ("Memcpy", "Memset")
NAME_CHARS = 120        # kernel names in the breakdown are cut to this


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def union_ns(intervals):
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def is_kernel(name):
    return not name.startswith(_NOT_KERNELS)


def is_band_kernel(name):
    return any(k in name for k in BAND_KERNELS)


class Trace:
    """Device operations and host ranges of one traced window.

    ``device_ops`` and ``ranges`` are lists of (name, start_ns, end_ns);
    the window runs from the first ``portbench.call`` range's start to the
    last one's end (or is given as ``window``)."""

    def __init__(self, device_ops, ranges, window=None):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        if window is None:
            calls = [r for r in self.ranges if r[0] == CALL_SPAN]
            window = (min(r[1] for r in calls), max(r[2] for r in calls))
        self.window = window
        w0, w1 = window
        self.device_ops = sorted(
            (n, max(s, w0), min(e, w1)) for n, s, e in device_ops
            if e > w0 and s < w1)

    @property
    def window_ns(self):
        return self.window[1] - self.window[0]

    def busy_ns(self):
        return union_ns([(s, e) for _, s, e in self.device_ops])

    def kernels(self):
        return [op for op in self.device_ops if is_kernel(op[0])]

    def band_kernels(self):
        return [op for op in self.device_ops if is_band_kernel(op[0])]

    def range_ns(self, names):
        """Summed length of the host ranges named in ``names``."""
        return sum(e - s for n, s, e in self.ranges if n in names)

    def self_ns(self, outer, inner):
        """Time in ``outer`` ranges less the ``inner`` ranges that lie
        inside one of them."""
        outs = [(s, e) for n, s, e in self.ranges if n in outer]
        starts = [s for s, _ in outs]
        total = sum(e - s for s, e in outs)
        for n, s, e in self.ranges:
            if n not in inner:
                continue
            i = bisect.bisect_right(starts, s) - 1
            # ranges of one thread nest: the enclosing outer range is the
            # latest to start at or before s, if it ends after e
            while i >= 0 and outs[i][1] < e:
                i -= 1
            if i >= 0 and outs[i][0] <= s:
                total -= e - s
        return total

    def top_device_ops(self, k=10):
        """[[name, seconds], ...]: the device operations that took most
        time, summed by name."""
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], t / 1e9] for n, t in top]

    def idle_gaps(self, k=10):
        """[[host range, seconds], ...]: the device's idle time inside the
        window, each gap between device operations named by the innermost
        host range open at its midpoint ("between calls" outside every
        call), summed by name, longest first."""
        busy = merged([(s, e) for _, s, e in self.device_ops])
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by = {}
        stack = []
        ri = 0
        for a, b in gaps:
            mid = (a + b) / 2
            while ri < len(self.ranges) and self.ranges[ri][1] <= mid:
                stack.append(self.ranges[ri])
                ri += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            inner = [r for r in stack if r[1] <= mid < r[2]]
            name = inner[-1][0] if inner else "between calls"
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in top]


def from_profiler(prof):
    """A :class:`Trace` from a stopped ``torch.profiler.profile``: device
    events that are not annotations, and the host's annotation ranges."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    ops, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.is_user_annotation():
            if dt == cpu:
                ranges.append((e.name(), s, end))
        elif dt == cuda:
            ops.append((e.name(), s, end))
    return Trace(ops, ranges)


class BandRecorder:
    """Records the chain shape (N, S, b, t) and item size of every band
    kernel launch while ``active``, by wrapping the program's two band
    wrappers, which the KKT backend looks up at each call."""

    NAMES = ("band_solve", "band_solve_tiled")

    def __init__(self):
        self.active = False
        self.shapes = []
        self._saved = {}

    def install(self):
        from dompc_tpu_torch.solver import band_qr
        for name in self.NAMES:
            fn = getattr(band_qr, name)
            self._saved[name] = fn

            def wrapped(D, U, Lo, rhs, *args, _fn=fn, **kw):
                if self.active and D.device.type == "cuda":
                    self.shapes.append((D.shape[0], D.shape[1], D.shape[2],
                                        rhs.shape[-1], D.element_size()))
                return _fn(D, U, Lo, rhs, *args, **kw)
            setattr(band_qr, name, wrapped)

    def remove(self):
        from dompc_tpu_torch.solver import band_qr
        for name, fn in self._saved.items():
            setattr(band_qr, name, fn)
        self._saved = {}
