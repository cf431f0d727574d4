"""``sysid`` of the PyTorch port against the JAX package's (CPU, float64).

* every op of ``ONNXOperations`` (the reference's 16), with its attributes
  and axis rules, against the JAX table to 1e-12;
* ``ONNXConversion`` raises ``ImportError`` in both packages without onnx;
* the graph walk of examples/tools/onnx_conversion/onnx_conversion_01.py's
  3-5-1 MLP on a stand-in graph (``SimpleNamespace`` nodes; both modules'
  ``_HAS_ONNX`` and ``numpy_helper`` patched in this test only), port
  against JAX to 1e-12;
* ``Sym`` operands: the operator-based ops compose with a ``Sym`` and the
  others raise ``TypeError``, in both packages alike.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dompc_tpu.sysid._onnxconversion as jonnx
import dompc_tpu_torch.sysid._onnxconversion as tonnx
from dompc_tpu import sym as jsym
from dompc_tpu_torch import sym as tsym

TOL = 1e-12
jops, tops = jonnx.ONNXOperations(), tonnx.ONNXOperations()


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _attr(**kw):
    """ONNX AttributeProto stand-ins (tests/test_onnx_ops.py:_attr)."""
    out = []
    for name, val in kw.items():
        a = SimpleNamespace(name=name)
        if isinstance(val, float):
            a.f = val
        elif isinstance(val, int):
            a.i = val
        else:
            a.ints = list(val)
        out.append(a)
    return out


_r = np.random.default_rng(0)
X = _r.standard_normal((2, 6))
Y = _r.standard_normal((2, 6))
Z = _r.standard_normal((2, 6))
A34 = _r.standard_normal((3, 4))
B54 = _r.standard_normal((5, 4))
C35 = _r.standard_normal((3, 5))
A23 = _r.standard_normal((2, 3))
B32 = _r.standard_normal((3, 2))
X3 = _r.standard_normal((2, 1, 6, 1))

# (op, positional operands, keyword operands): each op of the table with
# its attributes, index operands as arrays (graph initializers)
CASES = {
    "Tanh": ((X,), {}),
    "Sigmoid": ((X,), {}),
    "Relu": ((X,), {}),
    "Elu": ((X,), dict(attribute=_attr(alpha=0.5))),
    "MatMul": ((A23, B32), {}),
    "Add": ((X, Y, Z), {}),
    "Mul": ((X, Y), {}),
    "Sub": ((X, Y), {}),
    "Gemm": ((A34, B54, C35),
             dict(attribute=_attr(alpha=2.0, beta=0.5, transB=1))),
    "Sum": ((X, Y, Z), {}),
    "Concat": ((X, Y, np.arange(6.0)), dict(attribute=_attr(axis=0))),
    "Unsqueeze": ((X,), dict(axes=np.array([0, 3]))),
    "Squeeze": ((X3,), dict(attribute=_attr(axes=[1, -1]))),
    "Slice": ((X, np.array([1, 5]), np.array([5, -9])),
              dict(axes=np.array([1, 0]), steps=np.array([2, -1]))),
    "Reshape": ((X, np.array([3, -1])), {}),
    "Shape": ((X3,), {}),
}


def test_cases_cover_the_jax_table():
    ops = {k for k in vars(jonnx.ONNXOperations) if not k.startswith("_")}
    assert ops == set(CASES) == {
        k for k in vars(tonnx.ONNXOperations) if not k.startswith("_")}


@pytest.mark.parametrize("op", sorted(CASES))
def test_op_matches_jax(op):
    args, kw = CASES[op]
    ref = np.asarray(getattr(jops, op)(*args, **kw))
    # tensor operands (index operands stay arrays, as initializers of a
    # converted graph would be tensors too: check both forms)
    t_args = [torch.as_tensor(a) if a.dtype.kind == "f" else a
              for a in args]
    for got in (getattr(tops, op)(*args, **kw),
                getattr(tops, op)(*t_args, **kw)):
        if op == "Shape":
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, ref)
            continue
        assert torch.is_tensor(got) and got.dtype == torch.float64
        assert got.shape == ref.shape, (got.shape, ref.shape)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_conversion_raises_without_onnx():
    model = SimpleNamespace(graph=None)
    for mod in (jonnx, tonnx):
        assert not mod._HAS_ONNX
        with pytest.raises(ImportError):
            mod.ONNXConversion(model)


def _mlp_graph():
    """examples/tools/onnx_conversion/onnx_conversion_01.py's 3-5-1 MLP as
    a stand-in ONNX graph (float32 initializers, as the example writes)."""
    rng = np.random.default_rng(0)
    W1, b1 = rng.standard_normal((3, 5)), rng.standard_normal(5)
    W2, b2 = rng.standard_normal((5, 1)), rng.standard_normal(1)

    def node(op, ins, out):
        return SimpleNamespace(op_type=op, input=ins, output=[out],
                               attribute=[])
    inits = [SimpleNamespace(name=n, array=a.astype(np.float32))
             for a, n in ((W1, "W1"), (b1, "b1"), (W2, "W2"), (b2, "b2"))]
    graph = SimpleNamespace(
        node=[node("MatMul", ["input", "W1"], "h0"),
              node("Add", ["h0", "b1"], "h1"),
              node("Relu", ["h1"], "hidden"),
              node("MatMul", ["hidden", "W2"], "o0"),
              node("Add", ["o0", "b2"], "output")],
        initializer=inits,
        input=[SimpleNamespace(name="input")] + inits,
        output=[SimpleNamespace(name="output")])
    return SimpleNamespace(graph=graph)


def test_graph_walk_matches_jax(monkeypatch):
    helper = SimpleNamespace(to_array=lambda t: t.array)
    for mod in (jonnx, tonnx):
        monkeypatch.setattr(mod, "_HAS_ONNX", True)
        monkeypatch.setattr(mod, "numpy_helper", helper, raising=False)
    model = _mlp_graph()
    x = np.random.default_rng(1).standard_normal((4, 3))
    jc = jonnx.ONNXConversion(model).convert(input=x)
    tc = tonnx.ONNXConversion(model).convert(input=x)
    assert tc.input_names == jc.input_names == ["input"]
    assert tc.output_names == ["output"]
    assert tc.initialized_tensors["W1"].dtype == torch.float64
    for layer in ("h1", "hidden", "output"):
        got, ref = tc[layer], np.asarray(jc[layer])
        assert got.device.type == "cpu" and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    # the layer by hand, from the float32 weights
    g = model.graph.initializer
    h = np.maximum(x @ g[0].array + g[1].array, 0.0)
    np.testing.assert_allclose(tc["output"].numpy(),
                               h @ g[2].array + g[3].array, rtol=1e-12)


def test_sym_operands_as_in_jax():
    """Only the operator-based ops compose with a ``Sym`` (Queue 3 of
    ROADMAP.md: the JAX docstring promises Sym values everywhere)."""
    W = np.ones((2, 2))
    for sym, ops in ((jsym, jops), (tsym, tops)):
        s = sym.var("_x", "s")
        assert isinstance(ops.Add(s, W[0]), sym.Sym)
        assert isinstance(ops.Mul(s, 2.0), sym.Sym)
        for op, args in (("MatMul", (s, W)), ("Tanh", (s,)),
                         ("Relu", (s,)), ("Sigmoid", (s,))):
            with pytest.raises(TypeError):
                getattr(ops, op)(*args)
