"""Mixed-integer MPC (batched branch-and-bound) of the PyTorch port against
the JAX package (float64, CPU).

The flows of ``tests/test_minlp_bnb.py`` (a scalar discrete MINLP, N=3,
whose continuous relaxation is fractional), each package building the MPC
from the same code:

* the first step: the same number of node relaxations (``bnb_nodes > 0``),
  the same integer input sequence exactly, and the incumbent's objective
  within 1e-8; the incumbent is the brute-force optimum;
* ``"round"`` against ``"bnb"``: the same rounded sequence as JAX, and
  branch-and-bound no worse than rounding;
* four closed-loop steps with a ``Simulator``: integral inputs equal to
  JAX's, the same node counts, ``kkt_err < 1e-6``.

Lotka-Volterra's integer MPC (``tests/test_lotka_volterra.py``, N=25, 70
node relaxations a step) for two closed-loop steps is marked ``slow``
(~3 min, most of it JAX compiling and running its node batches): inputs
exactly, states within 1e-8.
"""
import itertools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dompc_tpu as jdm
import dompc_tpu.systems  # noqa: F401
import dompc_tpu_torch as tdm


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


A_DYN, TARGET, RFAC = 0.5, 2.3, 0.05
N_HOR, U_MAX = 3, 3
X0 = np.array([0.3])
N_LOOP = 4


def _make_mpc(dm, strategy):
    """tests/test_minlp_bnb.py:_make_mpc, for either package."""
    m = dm.model.Model("discrete")
    x = m.set_variable("_x", "x")
    u = m.set_variable("_u", "u", input_type_integer=True)
    m.set_rhs("x", A_DYN * x + u)
    m.setup()
    mpc = dm.controller.MPC(m)
    s = mpc.settings
    s.n_horizon = N_HOR
    s.t_step = 1.0
    s.minlp_strategy = strategy
    cost = (m.x["x"] - TARGET) ** 2
    mpc.set_objective(lterm=cost, mterm=cost)
    mpc.set_rterm(u=RFAC)
    mpc.bounds["lower", "_x", "x"] = -10
    mpc.bounds["upper", "_x", "x"] = 10
    mpc.bounds["lower", "_u", "u"] = 0
    mpc.bounds["upper", "_u", "u"] = U_MAX
    mpc.setup()
    return mpc


def _exact_cost(x0, u_seq, u_prev=0.0):
    cost, x, up = 0.0, float(x0), float(u_prev)
    for u in u_seq:
        cost += (x - TARGET) ** 2 + RFAC * (u - up) ** 2
        x = A_DYN * x + u
        up = u
    return cost + (x - TARGET) ** 2


def _brute_force(x0):
    return min((_exact_cost(x0, seq), seq)
               for seq in itertools.product(range(U_MAX + 1),
                                            repeat=N_HOR))


def _u_seq(mpc):
    L = mpc.layout
    return [float(np.asarray(mpc.opt_x_num)[L.sl(("u", k, 0))][0])
            for k in range(N_HOR)]


def _objective(mpc):
    """The NLP objective at the incumbent, by the package's own oracle."""
    w, p = mpc.opt_x_num, mpc.opt_p_num
    if isinstance(mpc, tdm.controller.MPC):
        return float(mpc._f_fn(torch.as_tensor(w), torch.as_tensor(p)))
    return float(mpc._f_fn(jnp.asarray(w), jnp.asarray(p)))


def _loop(dm, strategy, n_steps):
    mpc = _make_mpc(dm, strategy)
    sim = dm.Simulator(mpc.model)
    sim.set_param(t_step=1.0)
    sim.setup()
    x0 = X0.copy()
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    steps = []
    for _ in range(n_steps):
        u0 = mpc.make_step(x0)
        steps.append(dict(u0=float(u0[0, 0]), seq=_u_seq(mpc),
                          f=_objective(mpc), x0=x0.copy(),
                          **mpc.solver_stats))
        x0 = sim.make_step(u0).reshape(-1)
    return steps, x0


@pytest.fixture(scope="module")
def bnb_loops(_cpu_port):
    return _loop(jdm, "bnb", N_LOOP), _loop(tdm, "bnb", N_LOOP)


def test_bnb_first_step_matches_jax(bnb_loops):
    (steps_j, _), (steps_t, _) = bnb_loops
    sj, st = steps_j[0], steps_t[0]
    assert st["bnb_nodes"] > 0 and st["bnb_nodes"] == sj["bnb_nodes"]
    assert st["seq"] == sj["seq"]
    assert np.allclose(st["seq"], np.round(st["seq"]), rtol=0, atol=1e-8)
    assert abs(st["f"] - sj["f"]) <= 1e-8 * max(1.0, abs(sj["f"]))
    best, best_seq = _brute_force(X0[0])
    assert st["u0"] == best_seq[0]
    assert abs(_exact_cost(X0[0], st["seq"]) - best) < 1e-6


def test_bnb_no_worse_than_rounding_as_in_jax(bnb_loops):
    (_, _), (steps_t, _) = bnb_loops
    mj, mt = _make_mpc(jdm, "round"), _make_mpc(tdm, "round")
    for mpc in (mj, mt):
        mpc.x0 = X0
        mpc.set_initial_guess()
        mpc.make_step(X0)
    assert "bnb_nodes" not in mt.solver_stats
    assert _u_seq(mt) == _u_seq(mj)
    assert float(np.abs(mt.opt_x_num - np.asarray(mj.opt_x_num)).max()) \
        <= 1e-8
    cost_round = _exact_cost(X0[0], np.round(_u_seq(mt)))
    cost_bnb = _exact_cost(X0[0], steps_t[0]["seq"])
    assert cost_bnb <= cost_round + 1e-9
    assert abs(cost_bnb - _brute_force(X0[0])[0]) < 1e-6


def test_bnb_closed_loop_matches_jax(bnb_loops):
    (steps_j, xj), (steps_t, xt) = bnb_loops
    for sj, st in zip(steps_j, steps_t):
        assert st["u0"] == sj["u0"] == round(st["u0"])
        assert st["seq"] == sj["seq"]
        assert st["bnb_nodes"] == sj["bnb_nodes"]
        assert st["iter_count"] == sj["iter_count"]
        assert st["kkt_err"] < 1e-6
        assert abs(st["f"] - sj["f"]) <= 1e-8 * max(1.0, abs(sj["f"]))
    assert float(np.abs(xt - xj).max()) <= 1e-12
    assert abs(xt[0] - TARGET) < 1.0


def _lv_loop(pkg, n_steps=2):
    model = pkg.systems.lotka_volterra_model_integer()
    mpc = pkg.systems.lotka_volterra_mpc(model)
    sim = pkg.Simulator(model)
    sim.set_param(t_step=0.3, substeps=4)
    sim.setup()
    x0 = np.array([0.5, 0.7])
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    nodes = []
    for _ in range(n_steps):
        u0 = mpc.make_step(x0)
        nodes.append(mpc.solver_stats["bnb_nodes"])
        x0 = sim.make_step(u0).reshape(-1)
    return np.asarray(mpc.data["_u"]), np.asarray(mpc.data["_x"]), x0, \
        nodes


@pytest.mark.slow
def test_lotka_volterra_integer_closed_loop_matches_jax():
    u_j, x_j, xe_j, n_j = _lv_loop(jdm)
    u_t, x_t, xe_t, n_t = _lv_loop(tdm)
    assert n_t == n_j
    assert np.array_equal(u_t, u_j)
    assert float(np.abs(x_t - x_j).max()) <= 1e-8
    assert float(np.abs(xe_t - xe_j).max()) <= 1e-8
