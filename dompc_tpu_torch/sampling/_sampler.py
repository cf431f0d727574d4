"""Plan execution (reference: do_mpc/sampling/_sampler.py:13-242).

Keeps the reference's resumable file-per-sample workflow (existing files are
skipped, ref :218) and adds :meth:`sample_batched`, which evaluates a sample
function over the whole plan in one batched call (``torch.func.vmap`` by
default) on the device of ``DOMPC_TPU_PLATFORM``: the batched replacement
for the reference's multiprocessing examples."""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..tools import printProgressBar


class Sampler:
    def __init__(self, sampling_plan, **kwargs):
        assert isinstance(sampling_plan, list)
        self.sampling_plan = sampling_plan
        self.sampling_vars = [k for k in sampling_plan[0].keys()
                              if k != "id"]
        self.n_samples = len(sampling_plan)
        self.data_dir = "./"
        self.sample_name = "sample"
        self.save_format = "pickle"
        self.overwrite = False
        self.print_progress = True
        self.sample_function = None
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
                print(f"Warning: {k} is not a valid Sampler param.")
            else:
                setattr(self, k, v)

    def set_sample_function(self, sample_function):
        """``sample_function(**case_vars) -> result`` (reference :133)."""
        self.sample_function = sample_function

    def _save_name(self, sample_id):
        name = f"{self.sample_name}_{sample_id}"
        ext = ".pkl" if self.save_format == "pickle" else ".mat"
        return os.path.join(self.data_dir, name + ext)

    def _save(self, save_name, result):
        os.makedirs(self.data_dir, exist_ok=True)
        if self.save_format == "pickle":
            with open(save_name, "wb") as f:
                pickle.dump(result, f)
        elif self.save_format == "mat":
            from scipy.io import savemat
            savemat(save_name, {"res": result})

    def sample_idx(self, idx: int):
        """Run one plan entry; skip if its file exists (reference :198-228)."""
        assert self.sample_function is not None, "set_sample_function first"
        case = self.sampling_plan[idx]
        save_name = self._save_name(case["id"])
        if os.path.isfile(save_name) and not self.overwrite:
            return
        inputs = {k: v for k, v in case.items() if k != "id"}
        result = self.sample_function(**inputs)
        self._save(save_name, result)
        if self.print_progress:
            printProgressBar(idx + 1, self.n_samples, prefix="Progress:",
                             length=50)

    def sample_data(self):
        """Run the full plan sequentially (reference :230-242)."""
        for i in range(self.n_samples):
            self.sample_idx(i)

    def sample_batched(self, batched_function=None):
        """Evaluate the whole plan in one batched (vmapped) call.

        ``batched_function(**stacked_vars) -> pytree with leading batch
        axis``; defaults to ``torch.func.vmap`` of the scalar
        sample_function.  The plan's variables are stacked into tensors on
        the device of ``DOMPC_TPU_PLATFORM`` (floating ones in the dtype of
        ``DOMPC_TPU_X64``).  Results come back as numpy and are written to
        the same per-sample files, so DataHandler and resumability work
        unchanged.
        """
        import torch
        from torch.utils._pytree import tree_map
        from .._config import resolve_device, resolve_dtype

        device, dtype = resolve_device(), resolve_dtype()

        def stack(k):
            a = np.stack([np.asarray(c[k]) for c in self.sampling_plan])
            t = torch.as_tensor(a, device=device)
            return t.to(dtype) if t.is_floating_point() else t

        stacked = {k: stack(k) for k in self.sampling_vars}
        if batched_function is None:
            assert self.sample_function is not None
            fn = torch.func.vmap(lambda kw: self.sample_function(**kw))
            results = fn(stacked)
        else:
            results = batched_function(**stacked)
        results = tree_map(
            lambda a: a.detach().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a), results)
        for i, case in enumerate(self.sampling_plan):
            res_i = tree_map(lambda a: a[i], results)
            self._save(self._save_name(case["id"]), res_i)
        return results
