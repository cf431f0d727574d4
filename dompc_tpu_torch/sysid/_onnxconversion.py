"""ONNX graph -> torch expression walker (port of the JAX package's
``sysid/_onnxconversion.py``; reference do_mpc/sysid/_onnxconversion.py:
10-424).

Each ONNX op of the reference set (ONNXOperations, ref :305-419) becomes a
torch computation; the graph walker evaluates a network node by node on
tensors of the port's dtype and device.  As in the JAX package, only the
operator-based ops (``Add``, ``Sum``, ``Mul``, ``Sub``) compose with a
``Sym``; the others take tensors (or arrays).
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import onnx  # noqa: F401
    from onnx import numpy_helper
    _HAS_ONNX = True
except ImportError:  # gated in dompc_tpu_torch.__init__
    _HAS_ONNX = False

from .._config import resolve_device, resolve_dtype
from ..sym import Sym


def _tensors(*xs):
    """The operands as tensors: arrays and numbers join the device of the
    first tensor among them (the CPU if there is none); tensors and None
    pass through, and so do all operands when one is a ``Sym`` (its own
    operators take them, as in the JAX package)."""
    if any(isinstance(x, Sym) for x in xs):
        return list(xs)
    ref = next((x for x in xs if torch.is_tensor(x)), None)
    device = ref.device if ref is not None else None
    return [x if x is None or torch.is_tensor(x)
            else torch.as_tensor(np.asarray(x), device=device) for x in xs]


def _host(x):
    """An index or shape operand (array, list or tensor) as a flat numpy
    vector."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def _attr(attribute, name, field, default):
    for a in attribute or ():
        if a.name == name:
            return getattr(a, field)
    return default


class ONNXOperations:
    """Each method evaluates one ONNX op on tensors (reference :305)."""

    def Tanh(self, x, attribute=None):
        return torch.tanh(*_tensors(x))

    def Sigmoid(self, x, attribute=None):
        x, = _tensors(x)
        return 1.0 / (1.0 + torch.exp(-x))

    def Relu(self, x, attribute=None):
        return torch.clamp_min(*_tensors(x), 0.0)

    def Elu(self, x, attribute=None):
        x, = _tensors(x)
        alpha = _attr(attribute, "alpha", "f", 1.0)
        return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))

    def MatMul(self, a, b, attribute=None):
        return torch.matmul(*_tensors(a, b))

    def Add(self, *args, attribute=None):
        args = _tensors(*args)
        out = args[0]
        for a in args[1:]:
            out = out + a
        return out

    def Mul(self, a, b, attribute=None):
        a, b = _tensors(a, b)
        return a * b

    def Sub(self, a, b, attribute=None):
        a, b = _tensors(a, b)
        return a - b

    def Gemm(self, a, b, c=None, attribute=None):
        a, b, c = _tensors(a, b, c)
        alpha = _attr(attribute, "alpha", "f", 1.0)
        beta = _attr(attribute, "beta", "f", 1.0)
        A = a.T if _attr(attribute, "transA", "i", 0) else a
        B = b.T if _attr(attribute, "transB", "i", 0) else b
        out = alpha * torch.matmul(A, B)
        if c is not None:
            out = out + beta * c
        return out

    def Sum(self, *args, attribute=None):
        return self.Add(*args)

    def Concat(self, *args, attribute=None):
        axis = _attr(attribute, "axis", "i", 0)
        return torch.cat([torch.atleast_2d(v) for v in _tensors(*args)],
                         dim=axis)

    def Unsqueeze(self, x, axes=None, attribute=None):
        x, = _tensors(x)
        ax = _attr(attribute, "axes", "ints", None)
        if ax is None and axes is not None:
            ax = _host(axes).tolist()
        for a in sorted(ax or [0]):
            x = torch.unsqueeze(x, int(a))
        return x

    def Squeeze(self, x, axes=None, attribute=None):
        x, = _tensors(x)
        ax = _attr(attribute, "axes", "ints", None)
        if ax is None and axes is not None:
            ax = _host(axes).tolist()
        if ax is None:
            return torch.squeeze(x)
        for a in sorted((int(a) % x.ndim for a in ax), reverse=True):
            if x.shape[a] != 1:
                raise ValueError(f"cannot squeeze axis {a} of size "
                                 f"{x.shape[a]}")
            x = torch.squeeze(x, a)
        return x

    def Slice(self, x, starts, ends, axes=None, steps=None, attribute=None):
        x, = _tensors(x)
        starts, ends = _host(starts), _host(ends)
        axes = _host(axes) if axes is not None else np.arange(len(starts))
        steps = (_host(steps) if steps is not None
                 else np.ones(len(starts), int))
        for s, e, a, st_ in zip(starts, ends, axes, steps):
            a = int(a)
            sl = slice(int(s), int(e), int(st_))
            if st_ > 0:
                x = x[(slice(None),) * (a % x.ndim) + (sl,)]
            else:       # torch slices step forward only
                idx = torch.arange(*sl.indices(x.shape[a]), device=x.device)
                x = torch.index_select(x, a, idx)
        return x

    def Reshape(self, x, shape, attribute=None):
        x, = _tensors(x)
        return torch.reshape(x, tuple(_host(shape).astype(int).tolist()))

    def Shape(self, x, attribute=None):
        return np.array(x.shape)


class ONNXConversion:
    """Evaluate an ONNX model as torch expressions (reference :10).

    Usage matches the reference: ``conv = ONNXConversion(model)``,
    ``conv.convert(input_name=value, ...)``, results via
    ``conv['layer_name']``.  Initializers and inputs become tensors on the
    port's device (``DOMPC_TPU_PLATFORM``), floating ones in its dtype
    (``DOMPC_TPU_X64``); integer initializers (shapes, axes) keep their
    integer type.  A ``Sym`` input passes through unchanged.
    """

    def __init__(self, model, model_name=None):
        if not _HAS_ONNX:
            raise ImportError("onnx is not installed")
        self.onnx_model = model
        graph = model.graph
        self.graph = graph
        self.device, self.dtype = resolve_device(), resolve_dtype()
        self.initialized_tensors = {
            t.name: self._tensor(np.asarray(numpy_helper.to_array(t)))
            for t in graph.initializer}
        self.inputs = [i for i in graph.input
                       if i.name not in self.initialized_tensors]
        self.input_names = [i.name for i in self.inputs]
        self.output_names = [o.name for o in graph.output]
        self.operations = ONNXOperations()
        self.values = {}

    def _tensor(self, arr):
        floating = np.issubdtype(arr.dtype, np.floating)
        return torch.as_tensor(arr, device=self.device,
                               dtype=self.dtype if floating else None)

    def convert(self, **kwargs):
        """Walk the graph node by node (reference convert, :182-276)."""
        missing = set(self.input_names) - set(kwargs)
        assert not missing, f"missing graph inputs: {missing}"
        vals = dict(self.initialized_tensors)
        for name in self.input_names:
            v = kwargs[name]
            if isinstance(v, Sym):
                vals[name] = v
            elif torch.is_tensor(v):
                vals[name] = v.to(device=self.device, dtype=self.dtype)
            else:
                vals[name] = self._tensor(np.asarray(v, dtype=float))
        for node in self.graph.node:
            op = getattr(self.operations, node.op_type, None)
            assert op is not None, (
                f"ONNX op {node.op_type!r} is not supported.")
            args = [vals[i] for i in node.input]
            out = op(*args, attribute=node.attribute)
            vals[node.output[0]] = out
        self.values = vals
        return self

    def __getitem__(self, key):
        assert key in self.values, (
            f"no layer {key!r}; call convert() first. Known: "
            f"{list(self.values)[:20]}")
        return self.values[key]
