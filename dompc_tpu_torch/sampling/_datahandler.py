"""Lazy post-processing over sample files
(reference: do_mpc/sampling/_datahandler.py:17-356)."""
from __future__ import annotations

import os
import pickle

import numpy as np


class DataHandler:
    def __init__(self, sampling_plan, **kwargs):
        self.sampling_plan = sampling_plan
        self.sampling_vars = [k for k in sampling_plan[0] if k != "id"]
        self.data_dir = "./"
        self.sample_name = "sample"
        self.save_format = "pickle"
        self.post_processing: dict = {}
        self._lazy_cache: dict = {}
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
                print(f"Warning: {k} is not a valid DataHandler param.")
            else:
                setattr(self, k, v)

    def set_post_processing(self, name: str, post_processing_function):
        """Register a named post-processing function applied to each loaded
        result (reference :287)."""
        self.post_processing[name] = post_processing_function

    def _load(self, sample_id):
        if sample_id in self._lazy_cache:
            return self._lazy_cache[sample_id]
        name = f"{self.sample_name}_{sample_id}"
        ext = ".pkl" if self.save_format == "pickle" else ".mat"
        path = os.path.join(self.data_dir, name + ext)
        if self.save_format == "pickle":
            with open(path, "rb") as f:
                res = pickle.load(f)
        else:
            from scipy.io import loadmat
            res = loadmat(path)["res"]
        self._lazy_cache[sample_id] = res
        return res

    def _process(self, case):
        res = self._load(case["id"])
        out = {k: v for k, v in case.items()}
        if self.post_processing:
            for name, fn in self.post_processing.items():
                out[name] = fn(res)
        else:
            out["res"] = res
        return out

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1) if idx != -1 else slice(-1, None)
        cases = self.sampling_plan[idx]
        if isinstance(cases, dict):
            cases = [cases]
        return [self._process(c) for c in cases]

    def filter(self, input_filter=None, output_filter=None):
        """Select cases by predicates over inputs and/or processed outputs
        (reference :172-240)."""
        assert input_filter is not None or output_filter is not None
        out = []
        for case in self.sampling_plan:
            if input_filter is not None:
                args = {k: case[k] for k in self.sampling_vars}
                import inspect
                sig = inspect.signature(input_filter).parameters
                if not input_filter(**{k: v for k, v in args.items()
                                       if k in sig}):
                    continue
            processed = self._process(case)
            if output_filter is not None:
                import inspect
                sig = inspect.signature(output_filter).parameters
                if not output_filter(**{k: v for k, v in processed.items()
                                        if k in sig}):
                    continue
            out.append(processed)
        return out
