"""Closure-based expression layer with a picklable op-tree (torch port).

A :class:`Sym` wraps a function ``env -> torch.Tensor`` where ``env`` is a
nested dict ``{var_type: {var_name: tensor}}``.  Arithmetic on Syms
composes closures; evaluation happens inside ``torch.func`` transforms
(``vmap``, ``jacfwd``, ``hessian``), so the closures are functional: no
in-place ops and no Python branching on tensor values (``if_else`` is
``torch.where``).

Every constructor also records the same op tree as the JAX package's
``sym`` module (tags ``const``/``var``/``pack``/``u``/``b``/``n``/
``getitem``/``reshape``), so a tree built there rebuilds into a torch
closure here (:func:`_from_tree`), and Syms pickle through their tree.
Syms wrapping raw user closures carry no tree and refuse to pickle.

Constants: Python scalars stay Python scalars (torch broadcasts them in
the tensor's dtype); array constants become tensors of the working dtype
and device, read from ``env[META]`` (set by ``Model._env``) and cached per
(dtype, device).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Sym", "var", "const", "to_sym", "is_sym",
    "exp", "log", "log10", "sin", "cos", "tan", "tanh", "sinh", "cosh",
    "arcsin", "arccos", "arctan", "atan", "atan2", "sqrt", "fabs", "sign",
    "fmin", "fmax", "floor", "ceil", "power", "if_else", "logic_and",
    "logic_or", "sum1", "sum2", "sumsqr", "norm_1", "norm_2", "dot", "mtimes",
    "vertcat", "horzcat", "blockcat", "reshape", "transpose", "diag", "trace",
    "inv", "sigmoid", "erf",
]

META = "__meta__"      # env key holding (dtype, device) of the evaluation


def _meta(env):
    return env.get(META, (torch.float64, torch.device("cpu")))


def _t(v, env):
    """Any operand -> tensor of the evaluation's dtype/device."""
    if isinstance(v, torch.Tensor):
        return v
    dtype, device = _meta(env)
    if isinstance(v, bool) or (isinstance(v, np.ndarray)
                               and v.dtype == np.bool_):
        return torch.as_tensor(v, device=device)
    return torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype,
                           device=device)


def _like(v, ref):
    """Python scalar -> tensor shaped like a scalar of ``ref``'s kind."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _pair(a, b):
    if isinstance(a, torch.Tensor):
        return a, _like(b, a)
    if isinstance(b, torch.Tensor):
        return _like(a, b), b
    return torch.as_tensor(a), torch.as_tensor(b)


def _matmul(a, b):
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor) \
            or a.ndim == 0 or b.ndim == 0:
        return a * b
    return a @ b


def _minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, max=a)
    return min(a, b)


def _maximum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, min=a)
    return max(a, b)


def _sum1(v):
    return torch.sum(v, dim=0) if v.ndim > 1 else torch.sum(v)


def _vertcat(*vals):
    if any(v.ndim > 1 for v in vals):
        vals = [v if v.ndim > 1 else torch.reshape(v, (-1, 1)) for v in vals]
        return torch.cat(vals, dim=0)
    return torch.cat([torch.atleast_1d(v) for v in vals])


def _horzcat(*vals):
    return torch.cat([torch.atleast_2d(v) for v in vals], dim=1)


def _dot(a, b):
    a, b = _pair(a, b)
    return torch.sum(torch.ravel(a) * torch.ravel(b))


def _transpose(v):
    return torch.permute(v, tuple(range(v.ndim - 1, -1, -1)))


_UNARY = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "tanh": torch.tanh, "sinh": torch.sinh,
    "cosh": torch.cosh, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sqrt": torch.sqrt, "fabs": torch.abs,
    "sign": torch.sign, "floor": torch.floor, "ceil": torch.ceil,
    "sigmoid": torch.sigmoid, "erf": torch.special.erf,
    "transpose": _transpose, "diag": torch.diag, "trace": torch.trace,
    "inv": torch.linalg.inv,
    "sum1": _sum1, "sum2": lambda v: torch.sum(v, dim=-1),
    "sumsqr": lambda v: torch.sum(torch.square(v)),
    "norm_1": lambda v: torch.sum(torch.abs(v)),
    "norm_2": lambda v: torch.sqrt(torch.sum(torch.square(v))),
}

_BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b, "matmul": _matmul,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "fmin": _minimum, "fmax": _maximum,
    "atan2": lambda a, b: torch.atan2(*_pair(a, b)),
    "logic_and": lambda a, b: torch.logical_and(*_pair(a, b)),
    "logic_or": lambda a, b: torch.logical_or(*_pair(a, b)),
    "dot": _dot,
}

_NARY = {
    "vertcat": _vertcat, "horzcat": _horzcat,
    "if_else": lambda c, t, f: torch.where(c, t, f),
}


def plain_tensor(make):
    """Run the tensor factory ``make()`` outside every ``torch.func``
    transform.  A constant made inside one (a first evaluation under
    ``jacfwd``, say) is a wrapper of that transform's level, and reusing it
    after the transform has exited fails functorch's level check; cached
    constants are therefore always made plain."""
    with torch._C._DisableFuncTorch():
        return make()


def _const_fn(c):
    if isinstance(c, (int, float)):
        return lambda env: c
    arr = np.asarray(c)
    cache = {}

    def fn(env):
        key = _meta(env)
        out = cache.get(key)
        if out is None:
            out = cache[key] = plain_tensor(lambda: _t(arr, env))
        return out
    return fn


def _unary_fn(opname, f):
    op = _UNARY[opname]
    return lambda env: op(_t(f(env), env))


def _binary_fn(opname, fa, fb):
    op = _BINARY[opname]
    return lambda env: op(fa(env), fb(env))


def _nary_fn(opname, fns):
    op = _NARY[opname]
    return lambda env: op(*[_t(f(env), env) for f in fns])


def _tree_of(v):
    if isinstance(v, Sym):
        return v.tree
    return ("const", v if isinstance(v, (int, float)) else np.asarray(v))


def _build(tree):
    """Rebuild the evaluation closure from an op tree."""
    tag = tree[0]
    if tag == "const":
        return _const_fn(tree[1])
    if tag == "var":
        vt, name = tree[1], tree[2]
        return lambda env: env[vt][name]
    if tag == "pack":
        vt, names = tree[1], tree[2]

        def pack(env):
            parts = []
            for name in names:
                v = _t(env[vt][name], env)
                parts.append(torch.reshape(v.T, (-1,)) if v.ndim > 1
                             else torch.reshape(v, (-1,)))
            if not parts:
                dtype, device = _meta(env)
                return torch.zeros((0,), dtype=dtype, device=device)
            return torch.cat(parts)
        return pack
    if tag == "u":
        return _unary_fn(tree[1], _build(tree[2]))
    if tag == "b":
        return _binary_fn(tree[1], _build(tree[2]), _build(tree[3]))
    if tag == "n":
        return _nary_fn(tree[1], [_build(t) for t in tree[2:]])
    if tag == "getitem":
        f, idx = _build(tree[1]), tree[2]
        return lambda env: f(env)[idx]
    if tag == "reshape":
        f, shape = _build(tree[1]), tree[2]
        return lambda env: torch.reshape(_t(f(env), env), shape)
    raise ValueError(f"unknown op-tree tag {tag!r}")


def _from_tree(tree, name=None):
    return Sym(_build(tree), name=name, tree=tree)


def _as_callable(v):
    if isinstance(v, Sym):
        return v.fn
    return _const_fn(v if isinstance(v, (int, float)) else np.asarray(v))


def to_sym(v) -> "Sym":
    if isinstance(v, Sym):
        return v
    return Sym(_as_callable(v), tree=_tree_of(v))


def is_sym(v) -> bool:
    return isinstance(v, Sym)


class Sym:
    """A deferred expression: ``self.fn(env)`` returns a tensor.

    ``env`` is ``{'_x': {...}, '_u': {...}, '_z': {...}, '_p': {...},
    '_tvp': {...}, '_w': {...}, '_v': {...}}`` (only the groups an
    expression reads need to be present).  ``tree`` is the picklable
    op-tree recipe, or None for raw user closures (which cannot pickle).
    """

    __slots__ = ("fn", "name", "tree")
    __array_priority__ = 1000  # make numpy defer to our __radd__ etc.

    def __init__(self, fn, name: str | None = None, tree=None):
        self.fn = fn
        self.name = name
        self.tree = tree

    def __call__(self, env):
        return self.fn(env)

    def __reduce__(self):
        if self.tree is None:
            raise TypeError(
                "cannot pickle a Sym wrapping a raw closure; build "
                "expressions from dompc_tpu_torch.sym operations to keep "
                "them serializable (reference limitation analogue: MX "
                "models do not pickle, do_mpc/model/_model.py:130-161)")
        return (_from_tree, (self.tree, self.name))

    # -- binary ops ---------------------------------------------------------
    def _bin(self, other, opname):
        return Sym(_binary_fn(opname, self.fn, _as_callable(other)),
                   tree=_maybe(("b", opname, self.tree, _tree_of(other))))

    def _rbin(self, other, opname):
        return Sym(_binary_fn(opname, _as_callable(other), self.fn),
                   tree=_maybe(("b", opname, _tree_of(other), self.tree)))

    def __add__(self, o): return self._bin(o, "add")
    def __radd__(self, o): return self._rbin(o, "add")
    def __sub__(self, o): return self._bin(o, "sub")
    def __rsub__(self, o): return self._rbin(o, "sub")
    def __mul__(self, o): return self._bin(o, "mul")
    def __rmul__(self, o): return self._rbin(o, "mul")
    def __truediv__(self, o): return self._bin(o, "div")
    def __rtruediv__(self, o): return self._rbin(o, "div")
    def __pow__(self, o): return self._bin(o, "pow")
    def __rpow__(self, o): return self._rbin(o, "pow")
    def __matmul__(self, o): return self._bin(o, "matmul")
    def __rmatmul__(self, o): return self._rbin(o, "matmul")

    def __neg__(self):
        return Sym(_unary_fn("neg", self.fn),
                   tree=_maybe(("u", "neg", self.tree)))

    def __pos__(self):
        return self

    # comparisons produce Syms too (useful with if_else)
    def __lt__(self, o): return self._bin(o, "lt")
    def __le__(self, o): return self._bin(o, "le")
    def __gt__(self, o): return self._bin(o, "gt")
    def __ge__(self, o): return self._bin(o, "ge")

    def __getitem__(self, idx):
        f = self.fn
        return Sym(lambda env: f(env)[idx],
                   tree=_maybe(("getitem", self.tree, idx)))

    @property
    def T(self):
        return Sym(_unary_fn("transpose", self.fn),
                   tree=_maybe(("u", "transpose", self.tree)))

    def reshape(self, shape):
        return reshape(self, shape)

    def __repr__(self):
        return f"Sym({self.name or '<expr>'})"


def _maybe(tree):
    """A tree is valid only if every Sym operand carried one."""
    return None if any(t is None for t in tree) else tree


def var(var_type: str, name: str) -> Sym:
    """A Sym reading ``env[var_type][name]``."""
    return Sym(lambda env: env[var_type][name], name=f"{var_type}.{name}",
               tree=("var", var_type, name))


def pack_var(var_type: str, names, shapes) -> Sym:
    """Concatenation of a whole variable group (SymView.cat)."""
    tree = ("pack", var_type, tuple(names), tuple(shapes))
    return Sym(_build(tree), name=f"{var_type}.cat", tree=tree)


def const(v) -> Sym:
    return to_sym(v)


# -- elementwise math -------------------------------------------------------

def _unary(opname):
    op = _UNARY[opname]

    def f(x):
        if isinstance(x, Sym):
            return Sym(_unary_fn(opname, x.fn),
                       tree=_maybe(("u", opname, x.tree)))
        return op(x if isinstance(x, torch.Tensor) else torch.as_tensor(x))
    return f


exp = _unary("exp")
log = _unary("log")
log10 = _unary("log10")
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
tanh = _unary("tanh")
sinh = _unary("sinh")
cosh = _unary("cosh")
arcsin = _unary("arcsin")
arccos = _unary("arccos")
arctan = _unary("arctan")
atan = arctan
sqrt = _unary("sqrt")
fabs = _unary("fabs")
sign = _unary("sign")
floor = _unary("floor")
ceil = _unary("ceil")
sigmoid = _unary("sigmoid")
erf = _unary("erf")
transpose = _unary("transpose")
diag = _unary("diag")
trace = _unary("trace")
inv = _unary("inv")


def _binary(opname):
    op = _BINARY[opname]

    def f(a, b):
        if isinstance(a, Sym) or isinstance(b, Sym):
            return Sym(_binary_fn(opname, _as_callable(a), _as_callable(b)),
                       tree=_maybe(("b", opname, _tree_of(a), _tree_of(b))))
        return op(a, b)
    return f


fmin = _binary("fmin")
fmax = _binary("fmax")
power = _binary("pow")
atan2 = _binary("atan2")
mtimes = _binary("matmul")
logic_and = _binary("logic_and")
logic_or = _binary("logic_or")


def dot(a, b):
    return Sym(_binary_fn("dot", _as_callable(a), _as_callable(b)),
               tree=_maybe(("b", "dot", _tree_of(a), _tree_of(b))))


def if_else(cond, if_true, if_false):
    fns = [_as_callable(cond), _as_callable(if_true), _as_callable(if_false)]
    return Sym(_nary_fn("if_else", fns),
               tree=_maybe(("n", "if_else", _tree_of(cond),
                            _tree_of(if_true), _tree_of(if_false))))


# -- reductions (CasADi semantics: sum1 = sum over rows/elements) -----------

def _reduction(opname):
    def f(x):
        return Sym(_unary_fn(opname, _as_callable(x)),
                   tree=_maybe(("u", opname, _tree_of(x))))
    return f


sum1 = _reduction("sum1")
sum2 = _reduction("sum2")
sumsqr = _reduction("sumsqr")
norm_1 = _reduction("norm_1")
norm_2 = _reduction("norm_2")


# -- concatenation ----------------------------------------------------------

def vertcat(*args):
    return Sym(_nary_fn("vertcat", [_as_callable(a) for a in args]),
               tree=_maybe(("n", "vertcat") + tuple(
                   _tree_of(a) for a in args)))


def horzcat(*args):
    return Sym(_nary_fn("horzcat", [_as_callable(a) for a in args]),
               tree=_maybe(("n", "horzcat") + tuple(
                   _tree_of(a) for a in args)))


def blockcat(rows):
    return vertcat(*[horzcat(*r) for r in rows])


def reshape(x, shape):
    f = _as_callable(x)
    return Sym(lambda env: torch.reshape(_t(f(env), env), shape),
               tree=_maybe(("reshape", _tree_of(x), shape)))
