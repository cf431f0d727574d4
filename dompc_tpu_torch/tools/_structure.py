"""Named flat-vector structures.

The reference leans on ``casadi.tools.struct_symSX`` for every variable group
(do_mpc/model/_model.py:960-1006) and on power-indexed numeric structures for
bounds/scaling (do_mpc/optimizer.py:233-446).  Here a :class:`StructSpec` is a
static ordered name->shape table with flat offsets; numeric data lives in plain
numpy arrays / torch tensors which pack/unpack through the spec.  Matrices flatten in
column-major (Fortran) order to match CasADi vectorization semantics.
"""
from __future__ import annotations

import numpy as np


def _shape_tuple(shape):
    if isinstance(shape, int):
        return (shape, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) == 1:
        return (shape[0], 1)
    return shape


class StructSpec:
    """Ordered collection of named blocks with shapes, flattened into one vector."""

    def __init__(self, entries=()):
        # entries: iterable of (name, shape)
        self.names: list[str] = []
        self.shapes: dict[str, tuple] = {}
        self.offsets: dict[str, int] = {}
        self.size = 0
        for name, shape in entries:
            self.add(name, shape)

    def add(self, name: str, shape):
        assert name not in self.shapes, f"duplicate entry {name!r}"
        shape = _shape_tuple(shape)
        self.names.append(name)
        self.shapes[name] = shape
        self.offsets[name] = self.size
        self.size += int(np.prod(shape))

    def block_size(self, name: str) -> int:
        return int(np.prod(self.shapes[name]))

    def slice(self, name: str) -> slice:
        o = self.offsets[name]
        return slice(o, o + self.block_size(name))

    def labels(self):
        out = []
        for name in self.names:
            n = self.block_size(name)
            out += [f"[{name},{i}]" for i in range(n)]
        return out

    # -- packing -----------------------------------------------------------
    def pack(self, d: dict, xp=np, dtype=None):
        """dict name->array  ->  flat vector (column-major per block)."""
        if self.size == 0:
            return xp.zeros((0,), dtype=dtype)
        parts = []
        for name in self.names:
            v = d[name]
            v = xp.asarray(v, dtype=dtype) if dtype else xp.asarray(v)
            parts.append(xp.reshape(v.T, (-1,)) if v.ndim > 1
                         else xp.reshape(v, (-1,)))
        return xp.concatenate(parts)

    def unpack(self, vec, xp=np) -> dict:
        """flat vector -> dict name->array (vectors 1-D, matrices 2-D)."""
        out = {}
        for name in self.names:
            s = self.slice(name)
            shape = self.shapes[name]
            blk = vec[..., s]
            if shape[1] == 1:
                out[name] = blk
            else:
                out[name] = xp.swapaxes(
                    xp.reshape(blk, blk.shape[:-1] + (shape[1], shape[0])),
                    -1, -2)
        return out

    def zeros(self, xp=np, dtype=float):
        return xp.zeros((self.size,), dtype=dtype)

    def full(self, value, xp=np, dtype=float):
        return xp.full((self.size,), value, dtype=dtype)

    def __contains__(self, name):
        return name in self.shapes

    def __iter__(self):
        return iter(self.names)

    def __repr__(self):
        return ("StructSpec(" + ", ".join(
            f"{n}:{self.shapes[n]}" for n in self.names) + ")")


class NumStruct:
    """Numeric vector with name-based get/set through a StructSpec.

    Mirrors the ergonomics of CasADi numeric structs used throughout the
    reference (e.g. ``mpc.x0['C_a'] = 0.5``)."""

    def __init__(self, spec: StructSpec, value=0.0, data=None):
        self.spec = spec
        if data is not None:
            self.data = np.asarray(data, dtype=float).reshape(-1).copy()
            assert self.data.size == spec.size
        else:
            self.data = spec.full(float(value))

    @property
    def cat(self):
        return self.data.reshape(-1, 1)

    @property
    def master(self):
        return self.data

    @master.setter
    def master(self, value):
        self.data[:] = np.asarray(value, dtype=float).reshape(-1)

    def __getitem__(self, name):
        if isinstance(name, tuple):
            if name and not isinstance(name[0], str):
                # positional multi-axis indexing: the reference's numeric
                # structs are (n, 1) casadi DMs, so 2-axis indexing like
                # ``struct[0, 0]`` must work — index a column view
                return self.data.reshape(-1, 1)[name]
            name, *rest = name
            blk = self._block(name)
            return blk[tuple(rest)]
        if not isinstance(name, str):
            # positional indexing falls through to the flat data (the
            # reference's numeric structs support both, e.g.
            # ``mhe.p_est0[0]``)
            return self.data[name]
        return self._block(name)

    def _block(self, name):
        s = self.spec.slice(name)
        shape = self.spec.shapes[name]
        view = self.data[s]
        if shape[1] == 1:
            return view.reshape(shape[0], 1)
        return view.reshape(shape[1], shape[0]).T

    def __setitem__(self, name, value):
        if not isinstance(name, str) and not (
                isinstance(name, tuple) and name
                and isinstance(name[0], str)):
            # positional assignment falls through to the flat data,
            # mirroring __getitem__ (multi-axis tuples address the
            # reference's (n, 1) column layout via a reshaped view)
            if isinstance(name, tuple) and len(name) > 1:
                # the reshaped write aliases self.data only when the
                # buffer is contiguous; a copy would silently drop the
                # assignment
                assert self.data.flags["C_CONTIGUOUS"]
                self.data.reshape(-1, 1)[name] = np.asarray(
                    value, dtype=float)
            else:
                self.data[name] = np.asarray(value, dtype=float)
            return
        if isinstance(name, tuple):
            name, *rest = name
            s = self.spec.slice(name)
            shape = self.spec.shapes[name]
            blk = self.data[s].reshape((shape[1], shape[0])).T.copy()
            val = np.asarray(value, dtype=float)
            tgt_shape = np.shape(blk[tuple(rest)])
            if val.shape != tgt_shape:
                val = np.broadcast_to(val.reshape(val.shape or (1,)),
                                      tgt_shape) if val.size == 1 \
                    else val.reshape(tgt_shape)
            blk[tuple(rest)] = val
            self.data[s] = blk.T.reshape(-1)
            return
        s = self.spec.slice(name)
        shape = self.spec.shapes[name]
        v = np.asarray(value, dtype=float)
        if v.size == 1:
            self.data[s] = float(v.reshape(-1)[0])
        else:
            self.data[s] = v.reshape(shape, order="C").T.reshape(-1) \
                if v.ndim > 1 else np.broadcast_to(v.reshape(-1), (s.stop - s.start,))

    def to_dict(self):
        return self.spec.unpack(self.data)

    def copy(self):
        return NumStruct(self.spec, data=self.data.copy())

    def __repr__(self):
        return f"NumStruct({ {n: self._block(n).ravel() for n in self.spec.names} })"


class FieldAccessor:
    """Power-index accessor, e.g. ``mpc.bounds['lower','_x','T_R'] = 50``.

    Replaces the reference's ``IndexedProperty`` descriptor
    (do_mpc/tools/_indexedproperty.py:3-45).  ``getter(key)``/``setter(key,
    value)`` receive the full index tuple.
    """

    def __init__(self, getter, setter):
        self._getter = getter
        self._setter = setter

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        return self._getter(key)

    def __setitem__(self, key, value):
        if not isinstance(key, tuple):
            key = (key,)
        self._setter(key, value)


class Structure:
    """Nested power-index container used by Graphics
    (reference: do_mpc/tools/_structure.py:15-192): values live at the
    finest keys, and any key prefix queries the flattened union —
    mirroring the reference's populated-Structure power indexing, e.g.
    ``graphics.pred_lines['_x', 'C_a']`` collects every scenario line of
    every element of that state, ``['_x', 'C_a', 0]`` just element 0's,
    and ``['_x']`` all state lines."""

    def __init__(self):
        self._data = {}

    def __setitem__(self, key, value):
        if not isinstance(key, tuple):
            key = (key,)
        self._data[key] = value

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        exact = self._data.get(key)
        if exact is not None:
            return exact
        # prefix query: flattened union over all finer keys (list values
        # concatenate, reference-style)
        out = []
        for k, v in self._data.items():
            if k[:len(key)] == key:
                out.extend(v if isinstance(v, list) else [v])
        if not out:
            raise KeyError(key)
        return out

    @property
    def full(self):
        """Every stored value, flattened (reference ``Structure.full``)."""
        out = []
        for v in self._data.values():
            out.extend(v if isinstance(v, list) else [v])
        return out

    def __contains__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        return key in self._data or any(
            k[:len(key)] == key for k in self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()
