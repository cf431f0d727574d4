"""Reference-style power indexing over the flat decision vector.

The reference exposes the full NLP solution as a CasADi numeric struct
indexed like ``mpc.opt_x_num['_x', k, s, j, name]``
(do_mpc/controller/_mpc.py:1126-1134; queried via cached index maps,
do_mpc/data.py:81-156).  Here the solution is a flat numpy vector laid out
by :class:`dompc_tpu_torch.optimizer.OCPLayout`; this module grafts the same
ergonomics onto it: :class:`OptXNumArray` is an ``np.ndarray`` subclass
whose ``__getitem__``/``__setitem__`` accept the reference power index
(field string first) and resolve it through the layout, while every other
indexing behaves exactly like a plain array — so all internal flat-vector
code keeps working on the same object.

Index semantics match the reference struct:

* MPC ``['_x', k, s, j]``: ``j`` in ``0..n_coll`` where the LAST entry is
  the stage-``k`` node and ``0..n_coll-1`` are the interior collocation
  points of interval ``k-1`` (the reference keeps dummy collocation
  entries at ``k == 0``; those do not exist here and raise).  Scenario
  indices beyond the tree width at stage ``k`` clamp to the last live
  scenario (the reference pads the struct with unused entries instead).
* ``['_z', k, s, j]``, ``['_u', k, s]``, ``['_eps', k, s]`` analogous.
* MHE (one chain, no scenario axis): ``['_x', k, j]``, ``['_z', k, j]``,
  ``['_u', k]``, ``['_w', k]``, ``['_v', k]``, ``['_eps', k]`` and the
  stage-free ``['_p_est']``.
* A trailing variable name selects that block, e.g.
  ``mpc.opt_x_num['_x', 1, 0, -1, 'C_a']``.
* Slices on any structural axis return (nested) lists, like the CasADi
  struct; integers may be negative.
"""
from __future__ import annotations

import numpy as np


class OptXResolver:
    """Resolves reference power indices to flat index arrays.

    ``fields``: name -> (shape tuple, fn(*idx) -> flat int index array).
    ``specs``: name -> StructSpec (or None) for trailing-name slicing.
    """

    def __init__(self, fields, specs):
        self.fields = fields
        self.specs = specs

    def _leaves(self, field, idx):
        if field not in self.fields:
            raise KeyError(
                f"unknown opt_x field {field!r}; available: "
                f"{sorted(self.fields)}")
        shape, fn = self.fields[field]
        name = None
        if idx and isinstance(idx[-1], str):
            name = idx[-1]
            idx = idx[:-1]
        if len(idx) > len(shape):
            raise IndexError(
                f"{field!r} takes at most {len(shape)} indices, got "
                f"{len(idx)}")
        idx = tuple(idx) + (slice(None),) * (len(shape) - len(idx))
        name_sl = None
        if name is not None:
            spec = self.specs.get(field)
            if spec is None or name not in spec:
                raise KeyError(f"unknown variable {name!r} in {field!r}")
            name_sl = spec.slice(name)

        def rec(prefix, axes, rest):
            if not rest:
                flat = np.asarray(fn(*prefix), dtype=int)
                return flat[name_sl] if name_sl is not None else flat
            i, size = rest[0], axes[0]
            if isinstance(i, slice):
                return [rec(prefix + (ii,), axes[1:], rest[1:])
                        for ii in range(*i.indices(size))]
            ii = int(i)
            if ii < 0:
                ii += size
            if not 0 <= ii < size:
                raise IndexError(
                    f"index {i} out of range for {field!r} axis of size "
                    f"{size}")
            return rec(prefix + (ii,), axes[1:], rest[1:])

        return rec((), shape, idx)

    def get(self, arr, key):
        leaves = self._leaves(key[0], key[1:])

        def build(node):
            if isinstance(node, list):
                return [build(x) for x in node]
            return np.asarray(arr)[node].copy()
        return build(leaves)

    def set(self, arr, key, value):
        leaves = self._leaves(key[0], key[1:])
        flat = []

        def collect(node):
            if isinstance(node, list):
                for x in node:
                    collect(x)
            else:
                flat.append(node)
        collect(leaves)
        tgt = np.concatenate(flat) if len(flat) != 1 else flat[0]
        val = np.asarray(value, dtype=float).reshape(-1)
        if val.size == 1:
            val = np.full(tgt.shape, val[0])
        np.asarray(arr)[tgt] = val.reshape(tgt.shape)


class OptXNumArray(np.ndarray):
    """Flat decision vector with reference power indexing grafted on."""

    _optx_resolver = None
    _optx_size = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self._optx_resolver = getattr(obj, "_optx_resolver", None)
            self._optx_size = getattr(obj, "_optx_size", None)

    @staticmethod
    def _as_power_key(key):
        if isinstance(key, str):
            return (key,)
        if (isinstance(key, tuple) and len(key) > 0
                and isinstance(key[0], str)):
            return key
        return None

    def _check_full_length(self):
        # derived arrays (slices, reductions) inherit the resolver via
        # __array_finalize__ but their flat indices no longer address
        # the full layout — refuse loudly instead of resolving wrong
        if self.ndim != 1 or (self._optx_size is not None
                              and self.shape[0] != self._optx_size):
            raise TypeError(
                "struct power indexing is only valid on the full-length "
                f"solution vector (layout size {self._optx_size}, this "
                f"array has shape {self.shape}) — index opt_x_num / "
                "opt_x_num_unscaled directly")

    def __getitem__(self, key):
        pk = self._as_power_key(key)
        if pk is not None and self._optx_resolver is not None:
            self._check_full_length()
            return self._optx_resolver.get(self, pk)
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        pk = self._as_power_key(key)
        if pk is not None and self._optx_resolver is not None:
            self._check_full_length()
            self._optx_resolver.set(self, pk, value)
            return
        super().__setitem__(key, value)

    def __reduce__(self):
        # drop the resolver (holds layout closures) for pickling; the
        # owning MPC/MHE re-wraps on assignment
        return (np.asarray, (np.asarray(self),))


def wrap_opt_x(arr, resolver):
    out = np.asarray(arr, dtype=float).view(OptXNumArray)
    out._optx_resolver = resolver
    out._optx_size = out.shape[0] if out.ndim == 1 else None
    return out


def make_mpc_resolver(mpc):
    """Build the resolver for an MPC layout (after prepare_nlp)."""
    L = mpc.layout
    st = mpc.settings
    model = mpc.model
    tree = mpc.scenario_tree
    nscen = tree["n_scenarios"]
    n_max = nscen[-1]
    N = st.n_horizon
    n_coll = mpc.n_total_coll_points
    n_x, n_z = model.n_x, model.n_z
    n_coll_z = max(n_coll, 1)
    n_eps_rep = 1 if st.nl_cons_single_slack else N

    def fx(k, s, j):
        if j == n_coll:
            return L.idx(("x_node", k, min(s, nscen[k] - 1)))
        if k == 0:
            raise IndexError(
                "['_x', 0, s, j] for j < n_coll addresses the reference's "
                "dummy initial collocation entries, which do not exist in "
                "this layout — use j = -1 for the initial node")
        c = min(s, nscen[k] - 1)
        return L.idx(("x_coll", k - 1, c))[j * n_x:(j + 1) * n_x]

    def fz(k, s, j):
        c = min(s, nscen[k + 1] - 1)
        return L.idx(("z", k, c))[j * n_z:(j + 1) * n_z]

    def fu(k, s):
        su = 0 if st.open_loop else min(s, nscen[k] - 1)
        return L.idx(("u", k, su))

    def feps(k, s):
        eps_scen = nscen[k] if n_eps_rep == N else n_max
        return L.idx(("eps", k, min(s, eps_scen - 1)))

    fields = {"_x": ((N + 1, n_max, n_coll + 1), fx),
              "_u": ((N, 1 if st.open_loop else n_max), fu)}
    if n_z:
        fields["_z"] = ((N, n_max, n_coll_z), fz)
    if mpc.n_eps_vars:
        fields["_eps"] = ((n_eps_rep, n_max), feps)
    specs = {"_x": model.spec("_x"), "_u": model.spec("_u"),
             "_z": model.spec("_z"), "_eps": mpc._eps_spec}
    return OptXResolver(fields, specs)


def make_mhe_resolver(mhe):
    """Build the resolver for an MHE layout (after setup)."""
    L = mhe.layout
    model = mhe.model
    N = mhe.settings.n_horizon
    n_coll = mhe.n_total_coll_points
    n_x, n_z = model.n_x, model.n_z
    n_coll_z = max(n_coll, 1)
    n_eps_rep = 1 if mhe.settings.nl_cons_single_slack else N

    def fx(k, j):
        if j == n_coll:
            return L.idx(("x_node", k, 0))
        if k == 0:
            raise IndexError(
                "['_x', 0, j] for j < n_coll addresses the reference's "
                "dummy initial collocation entries, which do not exist in "
                "this layout — use j = -1 for the initial node")
        return L.idx(("x_coll", k - 1, 0))[j * n_x:(j + 1) * n_x]

    def fz(k, j):
        return L.idx(("z", k, 0))[j * n_z:(j + 1) * n_z]

    fields = {"_x": ((N + 1, n_coll + 1), fx),
              "_u": ((N,), lambda k: L.idx(("u", k, 0)))}
    if n_z:
        fields["_z"] = ((N, n_coll_z), fz)
    if model.n_w:
        fields["_w"] = ((N,), lambda k: L.idx(("w", k)))
    if model.n_v:
        fields["_v"] = ((N,), lambda k: L.idx(("v", k)))
    if mhe.n_eps_vars:
        fields["_eps"] = ((n_eps_rep,),
                          lambda k: L.idx(("eps", k, 0)))
    if mhe.n_p_est:
        fields["_p_est"] = ((), lambda: L.idx(("p_est",)))
    specs = {"_x": model.spec("_x"), "_u": model.spec("_u"),
             "_z": model.spec("_z"), "_w": model.spec("_w"),
             "_v": model.spec("_v"), "_eps": mhe._eps_spec,
             "_p_est": mhe._p_est_spec}
    return OptXResolver(fields, specs)
