"""The float64 BBD solve's refinement passes (CPU): each pass opens span
``kkt.refine`` inside ``kkt.bbd_solve`` and counts once in
``bbd_solve.refine_passes``; the float32 batched path opens neither.  The
benchmark's readers of the new span and of the float64 band launches read
nothing without a trace."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dompc_tpu_torch.solver.bbd import bbd_matvec, bbd_solve

ROOT = Path(__file__).resolve().parents[1]


def _user_ranges(prof):
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda r: (r[1], -r[2]))


def _chains(B, C, S, b, R, seed):
    """A seeded batch of diagonally dominant BBD systems, float64."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, C, S, b, b)) + 6 * np.eye(b),
              0.5 * rng.standard_normal((B, C, S - 1, b, b)),
              0.5 * rng.standard_normal((B, C, S - 1, b, b)),
              0.3 * rng.standard_normal((B, C, S, b, R)),
              rng.standard_normal((B, R, R)) + 10 * np.eye(R),
              rng.standard_normal((B, C, S, b)),
              rng.standard_normal((B, R)))
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


@pytest.mark.parametrize("n_refine", [1, 2])
def test_refine_spans_and_counter_float64(n_refine):
    args = _chains(2, 3, 6, 4, 2, seed=40 + n_refine)
    count0 = bbd_solve.refine_passes
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x_c, x_r = bbd_solve(*args, n_refine=n_refine, backend="pallas")
    assert bbd_solve.refine_passes - count0 == n_refine
    ranges = _user_ranges(prof)
    outer = [r for r in ranges if r[0] == "kkt.bbd_solve"]
    refine = [r for r in ranges if r[0] == "kkt.refine"]
    assert len(outer) == 1 and len(refine) == n_refine
    for _, s, e in refine:
        assert outer[0][1] <= s and e <= outer[0][2]
    y_c, y_r = bbd_matvec(*args[:5], x_c, x_r)
    assert float((y_c - args[5]).abs().max()) < 1e-12
    assert float((y_r - args[6]).abs().max()) < 1e-12


def test_float32_batched_path_opens_no_refine(monkeypatch):
    """The float32 condensed KKT passes no refinement to the BBD solve: a
    traced cold call of the robust CSTR (N = 2, B = 1, two Newton steps)
    opens ``kkt.bbd_solve`` spans and no ``kkt.refine``."""
    monkeypatch.setenv("DOMPC_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("DOMPC_TPU_X64", raising=False)
    from dompc_tpu_torch.parallel import (initial_guess_from_x0,
                                          make_batch_solver)
    from dompc_tpu_torch.systems import bench_states, cstr_robust_mpc
    mpc = cstr_robust_mpc(n_horizon=2, n_robust=1)
    assert mpc._dtype == torch.float32
    solve = make_batch_solver(mpc, tol=1e-3, max_iter=2,
                              throughput_mode=True)
    x0s = bench_states(1)
    count0 = bbd_solve.refine_passes
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solve(x0s, initial_guess_from_x0(mpc, x0s))
    names = [r[0] for r in _user_ranges(prof)]
    assert names.count("kkt.bbd_solve") >= solve.ipm.newton_steps > 0
    assert "kkt.refine" not in names
    assert bbd_solve.refine_passes == count0


@pytest.mark.parametrize("metric", ["refine_ms_per_step",
                                    "band64_ms_per_step", "band64_roofline"])
def test_new_metric_readers_read_none_without_trace(metric, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from portbench.harness import registry
    ctx = SimpleNamespace(calls=[dict(steps=3)], traced=[], trace=None,
                          band_shapes=[], setup_s=1.0, window_s=1.0)
    assert registry.reader(metric)(ctx) is None
