"""The polymerization cell ``poly_sample_cold`` on the CPU: its float64
configuration's reference against the port, a tiny rehearsal that comes
out correct, the float32-rounded control that does not, and the states
its traffic mode hands over."""
import numpy as np
import pytest
import torch

from portbench.harness import bench, registry
from portbench.harness.control_f64 import f32_round, rounded_answers
from portbench.harness.traffic import StateStream
from portbench.reference.poly import complete_state
from portbench.tests.test_portbench_reference import _build, _pvec

BENCH = registry.load_benchmark()
CELL = "poly_sample_cold"
CONFIG = "poly_robust_n20_f64"
TINY = dict(cpu=True, batch=2, n_horizon=3)


@pytest.fixture
def port_f64(monkeypatch):
    monkeypatch.setenv("DOMPC_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("DOMPC_TPU_X64", "1")


def test_reference_nlp_is_the_ports_float64(port_f64):
    """f, g, h, the bounds and the layout of the reference equal the
    port's at N = 20, as for the other configurations."""
    cfg, ref, tr, prog = _build(CONFIG)
    assert cfg["dtype"] == "float64" and cfg["reduced"] == []
    mpc = prog.mpc
    assert mpc._dtype == torch.float64
    assert (tr.n, tr.m, tr.q) == (mpc.n_opt_x, mpc.n_opt_lagr, mpc._n_ineq)
    assert tr.n == cfg["sizes"]["variables"]
    assert np.array_equal(tr.lb, mpc._lb_opt_x)
    assert np.array_equal(tr.ub, mpc._ub_opt_x)
    assert np.array_equal(tr.u0_idx, mpc.layout.idx(("u", 0, 0)))
    rng = np.random.default_rng(1)
    x0 = complete_state(np.array(cfg["x_nominal"])[None])
    x0s = x0 * (1 + 0.01 * rng.standard_normal((3, x0.shape[1])))
    w = torch.as_tensor(prog.cold_guess(x0s)
                        * (1 + 0.05 * rng.standard_normal((3, tr.n))))
    pv = _pvec(mpc, x0s)
    fr, gr, hr = tr.functions(w, torch.as_tensor(x0s))
    for got, want in ((mpc._f_fn(w, pv), fr), (mpc._g_fn(w, pv), gr),
                      (mpc._h_fn(w, pv), hr)):
        assert got.shape == want.shape
        if not want.numel():
            continue
        scale = 1.0 + want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-13


def _run(trace=False, hook=None):
    cell = registry.Cell(BENCH, CELL)
    return bench.run_cell(cell, 2 ** 31 + 5, 0.2, trace, program_hook=hook,
                          log=lambda rec: None, **TINY)


def test_cell_rehearsal_is_correct():
    result, compared = _run(trace=True)
    assert result["correct"], compared
    assert result["attempted"] >= 2 and result["failed"] == 0
    # the CPU trace has no device events: of the cell's metrics only the
    # host span's reader reads
    assert set(result["metrics"]) == {"refine_ms_per_step"}
    assert result["metrics"]["refine_ms_per_step"]["value"] > 0
    assert bench.forbidden_modules() == []


def test_float32_control_is_not_correct():
    """The program's answers carried in float32, the precision below the
    configuration's, fail ``kkt_err_max``."""
    result, compared = _run(hook=rounded_answers)
    assert result["correct"] is False, compared
    numbers = {name: (value, limit) for name, value, limit in compared}
    value, limit = numbers["kkt_err_max"]
    assert value > limit


def test_f32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -30, np.pi, 0.0],
                     dtype=torch.float64)
    y = f32_round(x)
    assert y.dtype == torch.float64
    assert y[0] == 1.0 and y[1] == 1.0 and y[3] == 0.0
    assert float(y[2]) == float(np.float32(np.pi))


def _stream(seed):
    cell = registry.Cell(BENCH, CELL)
    return cell, StateStream(cell.traffic, cell.cfg["x_nominal"], seed)


def test_mode_states_are_completed_and_inside_the_bounds():
    """Every state the mode hands over has the T_adiab that
    ``complete_state`` derives (under its 382.15 K bound) and lies inside
    every state bound of the configuration, T_R and m_P with a margin."""
    cell, stream = _stream(2 ** 31 + 977)
    mode = registry.mode(cell.traffic["mode"])
    run = type("Run", (), {})()
    run.stream = stream
    x0s = mode.states(run)
    assert x0s.shape == (512, 10)
    assert np.array_equal(x0s, complete_state(x0s))
    ocp = cell.cfg["ocp"]
    for i, name in enumerate(ocp["x"]):
        lo = ocp["x_lower"].get(name, -np.inf)
        hi = ocp["x_upper"].get(name, np.inf)
        assert (x0s[:, i] > lo).all() and (x0s[:, i] < hi).all(), name
    assert x0s[:, 3].min() >= 361.65 and x0s[:, 3].max() <= 364.65
    assert x0s[:, 2].min() >= 26.05
    assert 375.0 < x0s[:, 9].min() and x0s[:, 9].max() < 382.15 - 1.0


def test_mode_draws_the_fixed_pool_in_seeded_orders():
    _, a = _stream(7)
    _, b = _stream(7)
    _, c = _stream(8)
    first = a.shuffled()
    assert np.array_equal(first, b.shuffled())
    key = (lambda x: x[np.lexsort(x.T)])
    other = c.shuffled()
    assert not np.array_equal(first, other)
    assert np.array_equal(key(first), key(other))


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_control_is_not_correct_on_the_card(control):
    """On the card, at the cell's traffic with 64 of its states: the run is
    correct, and with the float32-rounded control not correct, by
    ``kkt_err_max``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = registry.Cell(BENCH, CELL)
    result, compared = bench.run_cell(
        cell, 2 ** 31 + 101, 1.0, False, batch=64,
        program_hook=rounded_answers if control else None,
        log=lambda rec: None)
    assert result["correct"] is (not control), compared
    assert result["device"]["platform"] == "gpu"
    numbers = {name: (value, limit) for name, value, limit in compared}
    value, limit = numbers["kkt_err_max"]
    assert (value > limit) is control
