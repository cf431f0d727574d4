"""Sampling plan generation
(reference: do_mpc/sampling/_samplingplanner.py:13-280)."""
from __future__ import annotations

import itertools
import os

import numpy as np

from ..tools import save_pickle, load_pickle


class SamplingPlanner:
    """Declares sampled variables and builds plans of named cases."""

    def __init__(self, **kwargs):
        self.sampling_vars: list[dict] = []
        self.sampling_plan: list[dict] = []
        self.data_dir = "./"
        self.overwrite = False
        self.id_precision = 3
        self.set_param(**kwargs)

    @property
    def data_dir(self):
        return self._data_dir

    @data_dir.setter
    def data_dir(self, val):
        self._data_dir = val

    def set_param(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                print(f"Warning: {k} is not a valid SamplingPlanner param.")
            else:
                setattr(self, k, v)

    def set_sampling_var(self, name: str, fun_var_pdf=None):
        """Register a sampled variable; ``fun_var_pdf`` generates random
        values in :meth:`gen_sampling_plan` (reference :108)."""
        assert isinstance(name, str)
        assert fun_var_pdf is None or callable(fun_var_pdf)
        self.sampling_vars.append({"name": name, "fun_var_pdf": fun_var_pdf})

    def _id(self, idx):
        return str(idx).zfill(self.id_precision)

    def add_sampling_case(self, **kwargs):
        """Add one case with explicit values; unset variables are drawn
        from their generator (reference :147-194)."""
        case = {"id": self._id(len(self.sampling_plan))}
        for var in self.sampling_vars:
            name = var["name"]
            if name in kwargs:
                case[name] = kwargs.pop(name)
            else:
                assert var["fun_var_pdf"] is not None, (
                    f"No value or generator for {name!r}.")
                case[name] = var["fun_var_pdf"]()
        assert not kwargs, f"unknown sampling vars {list(kwargs)}"
        self.sampling_plan.append(case)
        return self.sampling_plan

    def gen_sampling_plan(self, n_samples: int):
        """Draw n_samples random cases (reference :198)."""
        for _ in range(n_samples):
            self.add_sampling_case()
        return self.sampling_plan

    def product(self, **kwargs):
        """Cartesian product over explicit value lists (reference :219)."""
        names = [v["name"] for v in self.sampling_vars]
        assert set(kwargs) == set(names), (
            f"product() needs values for exactly {names}")
        for combo in itertools.product(*[kwargs[n] for n in names]):
            self.add_sampling_case(**dict(zip(names, combo)))
        return self.sampling_plan

    def export(self, sampling_plan_name: str):
        """Pickle the plan to data_dir (reference :256)."""
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, sampling_plan_name)
        if not os.path.isfile(path + ".pkl") or self.overwrite:
            save_pickle(path, self.sampling_plan)
        else:
            raise FileExistsError(
                f"{path}.pkl exists; set overwrite=True to replace.")
        return self.sampling_plan
