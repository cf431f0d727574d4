"""``tools.profiler`` of the PyTorch port (CPU): the annotations are no-ops
without a trace, ``trace`` around a ``make_step`` writes a Chrome/Perfetto
JSON holding the solve's range, and the error cases raise (cf. the JAX
package's tests/test_profiler.py)."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import dompc_tpu_torch as dm
from dompc_tpu_torch.tools import profiler


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _toy_mpc():
    """tests/test_profiler.py:test_solve_is_annotated's MPC."""
    model = dm.model.Model("continuous")
    x = model.set_variable("_x", "x")
    u = model.set_variable("_u", "u")
    model.set_rhs("x", -x + u)
    model.setup()
    mpc = dm.controller.MPC(model)
    mpc.settings.n_horizon = 3
    mpc.settings.t_step = 0.5
    mpc.set_objective(mterm=x ** 2, lterm=x ** 2)
    mpc.set_rterm(u=0.01)
    mpc.setup()
    mpc.x0 = np.array([1.0])
    mpc.set_initial_guess()
    return mpc


def test_annotations_are_noops_without_trace():
    with profiler.annotate("unit-region"):
        with profiler.step_annotation("unit-step", 3):
            pass


def test_trace_holds_the_solve_range(tmp_path):
    mpc = _toy_mpc()
    logdir = tmp_path / "trace"
    with profiler.trace(str(logdir), create_perfetto_trace=True):
        u0 = mpc.make_step(np.array([1.0]))
    assert np.all(np.isfinite(u0)) and mpc._n_solves == 1
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "dompc_tpu_torch.MPC.solve/1" in names


def test_trace_errors(tmp_path):
    with pytest.raises(RuntimeError):
        profiler.stop_trace()
    with pytest.raises(ValueError):
        profiler.start_trace(str(tmp_path), create_perfetto_link=True)
    profiler.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError):
            profiler.start_trace(str(tmp_path))
    finally:
        path = profiler.stop_trace()
    assert os.path.isfile(path)
    with pytest.raises(RuntimeError):
        profiler.stop_trace()


def test_device_memory_profile_raises_on_cpu(tmp_path):
    with pytest.raises(RuntimeError):
        profiler.save_device_memory_profile(str(tmp_path / "mem.pkl"))
    assert not (tmp_path / "mem.pkl").exists()
