"""Result logging.

Re-design of the reference ``do_mpc/data.py`` (Data :35, MPCData :246,
save_results/load_results :376-457): a dict of row-appended numpy arrays with
power-index queries resolved through the model's :class:`StructSpec` instead
of cached CasADi index maps.  Fully picklable (holds no model reference, only
specs)."""
from __future__ import annotations

import os
import pickle

import numpy as np


class Data:
    """Per-module result store: every ``make_step`` appends one row per field."""

    def __init__(self, model):
        self.dtype = "float"
        # keep only the static specs — picklable, unlike the full model
        self._specs = {vt: model.spec(vt) for vt in
                       ("_x", "_u", "_z", "_p", "_tvp", "_y", "_aux", "_w", "_v")}
        self.data_fields = {
            "_time": 1,
            "_x": model.n_x,
            "_y": model.n_y,
            "_u": model.n_u,
            "_z": model.n_z,
            "_tvp": model.n_tvp,
            "_p": model.n_p,
            "_aux": model.n_aux,
        }
        self.meta_data = {}
        self.init_storage()

    def init_storage(self):
        """Reset all logged data (reference: data.py:160)."""
        for field, dim in self.data_fields.items():
            setattr(self, field, np.empty((0, dim)))

    def set_meta(self, **kwargs):
        self.meta_data.update(kwargs)

    def update(self, **kwargs):
        """Append one row per supplied field (reference: data.py:173-218)."""
        for field, value in kwargs.items():
            arr = getattr(self, field)
            v = np.asarray(value, dtype=float).reshape(1, -1)
            dim = self.data_fields[field]
            if v.shape[1] != dim:
                v = v.reshape(1, dim)
            setattr(self, field, np.concatenate([arr, v], axis=0))

    def export(self):
        return {field: getattr(self, field) for field in self.data_fields}

    # ----------------------------------------------------------------- query
    def __getitem__(self, key):
        """Power-index query, e.g. ``data['_x', 'C_a']`` (reference: :81-156)."""
        if not isinstance(key, tuple):
            key = (key,)
        field = key[0]
        arr = getattr(self, field)
        if len(key) == 1:
            return arr
        name = key[1]
        spec = self._spec_for(field)
        sl = spec.slice(name)
        out = arr[:, sl]
        if len(key) >= 3:
            out = out[:, np.asarray(key[2]).reshape(-1)]
        return out

    def _spec_for(self, field):
        if field in self._specs:
            return self._specs[field]
        raise KeyError(f"no struct spec for field {field!r}")


class MPCData(Data):
    """Data subclass adding prediction-trajectory queries
    (reference: data.py:246-372)."""

    def __init__(self, model):
        super().__init__(model)
        self._pred_layout = None  # set by MPC when store_full_solution

    def prediction(self, ind, t_ind=-1):
        """Reconstruct predicted trajectories from the stored full solution.

        ``ind = ('_x'|'_u'|'_z'|'_aux', var_name[, elem])``; returns an array
        of shape (n_elements, horizon_points, n_scenarios) like the reference
        (data.py:246).  Requires ``store_full_solution=True``.
        """
        assert self._pred_layout is not None, (
            "prediction() requires store_full_solution=True")
        layout = self._pred_layout
        field, name = ind[0], ind[1]
        elem = ind[2] if len(ind) > 2 else None
        if field == "_aux":
            return layout.extract_aux(self._opt_aux_num[int(t_ind)],
                                      name, elem=elem)
        opt_x_num = self._opt_x_num[int(t_ind)]
        return layout.extract(opt_x_num, field, name, elem=elem)


def save_results(save_list, result_name="results", result_path="./results/",
                 overwrite=False):
    """Pickle the Data of the supplied modules (reference: data.py:376-432)."""
    if not os.path.exists(result_path):
        os.makedirs(result_path)

    results = {}
    for obj in save_list:
        if isinstance(obj, Data):
            data = obj
            name = "data"
        else:
            data = obj.data
            name = type(obj).__name__.lower()
            name = {"mpc": "mpc", "simulator": "simulator", "mhe": "mhe",
                    "ekf": "estimator", "statefeedback": "estimator",
                    "lqr": "mpc"}.get(name, name)
        results[name] = data

    filename = result_name if result_name.endswith(".pkl") else result_name + ".pkl"
    path = os.path.join(result_path, filename)
    if not overwrite:
        base = path[:-4]
        i = 1
        while os.path.exists(path):
            path = f"{base}_{i:03d}.pkl"
            i += 1
    with open(path, "wb") as f:
        pickle.dump(results, f)
    return path


def load_results(file_name):
    """Load pickled results (reference: data.py:437-457)."""
    with open(file_name, "rb") as f:
        return pickle.load(f)
