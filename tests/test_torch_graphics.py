"""Graphics of the PyTorch port against the JAX package's (matplotlib Agg).

The flow of ``tests/test_satellites.py:176-219``: the oscillating masses'
MPC and a Simulator run 3 closed-loop steps in each package from the same
seeded state, then ``Graphics`` draws the results and the stored
predictions, and ``default_plot`` the simulator's data.  The handle counts
of every line structure are equal, and every line's ``ydata`` agrees with
the JAX package's to 1e-8.  ``animate`` writes a file (an HTML fallback
where no movie writer is installed).
"""
import numpy as np
import pytest
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


def _loop(dm):
    """tests/test_satellites.py:181-195 for either package."""
    model = dm.systems.oscillating_masses_model()
    mpc = dm.systems.oscillating_masses_mpc(model)
    sim = dm.Simulator(model)
    sim.set_param(t_step=0.5)
    sim.setup()
    np.random.seed(99)
    x0 = np.random.rand(4) - 0.5
    mpc.x0 = x0
    sim.x0 = x0
    mpc.set_initial_guess()
    for _ in range(3):
        u0 = mpc.make_step(x0)
        x0 = sim.make_step(u0).reshape(-1)
    return mpc, sim


def _draw(dm, mpc, sim):
    """tests/test_satellites.py:197-219's drawing for either package."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(2)
    g = dm.graphics.Graphics(mpc.data)
    g.add_line("_x", "x", ax[0])
    g.add_line("_u", "u", ax[1])
    g.plot_results()
    g.plot_predictions(t_ind=-1)
    g.reset_axes()
    fig2, axes2, g2 = dm.graphics.default_plot(sim.data)
    return fig, g, g2


def _ydata(handles):
    return [np.asarray(h.get_ydata(), dtype=float) for h in handles]


def test_graphics_match_jax(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jg = _draw(jdm, *_loop(jdm))
    fig, tg, tg2 = _draw(tdm, *_loop(tdm))
    jg, jg2 = jg[1], jg[2]
    keys = [("_x", "x"), ("_x", "x", 0), ("_x",), ("_u", "u")]
    for key in keys:
        assert len(tg.result_lines[key]) == len(jg.result_lines[key]), key
        assert len(tg.pred_lines[key]) == len(jg.pred_lines[key]), key
    assert len(tg.result_lines["_x", "x"]) == 4
    assert len(tg.result_lines.full) == len(jg.result_lines.full) == 5
    assert len(tg.pred_lines.full) == len(jg.pred_lines.full) >= 5
    assert ("_x", "x") in tg.result_lines
    assert set(tg.pred_lines["_x", "x", 0]) <= set(tg.pred_lines["_x", "x"])
    for structs in ((tg.result_lines, jg.result_lines),
                    (tg.pred_lines, jg.pred_lines),
                    (tg2.result_lines, jg2.result_lines)):
        t_y, j_y = _ydata(structs[0].full), _ydata(structs[1].full)
        assert len(t_y) == len(j_y) > 0
        for a, b in zip(t_y, j_y):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
    for line_t, line_j in zip(tg.line_list, jg.line_list):
        np.testing.assert_allclose(
            np.asarray(line_t["result_handles"][0].get_xdata(), float),
            np.asarray(line_j["result_handles"][0].get_xdata(), float),
            rtol=1e-12)
    for h in tg.pred_lines["_x"]:
        h.set_alpha(0.5)
    anim = tdm.graphics.animate(tg, fig, n_steps=2,
                                export_path=str(tmp_path), export_name="a")
    assert anim is not None
    assert any(p.name.startswith("a.") for p in tmp_path.iterdir())
    plt.close("all")
