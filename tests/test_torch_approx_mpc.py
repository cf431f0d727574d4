"""Approximate MPC of the PyTorch port against the JAX package's (CPU).

* ``FeedforwardNN`` with the JAX package's initial weights carried across
  (``ApproxMPC.params``, the flax parameter tree as numpy) gives the same
  outputs to 1e-12 on float64 inputs: both keep float32 weights and compute
  in the input's dtype;
* a policy pickled by either package loads in the other;
* ``Trainer``, 20 epochs with shuffling, from the same weights and data:
  the loss and update-norm histories to 1e-5 relative (float32 Adam in
  both; the JAX trainer on one device);
* the plateau scheduler (``tests/test_trainer_dp.py:28-70``, ported);
* ``AMPCSampler.sample_open_loop_batched`` on the oscillating masses (32
  samples, batches of 16): inputs to 1e-8 and success flags equal, with the
  JAX package's unused ``u_prev`` matched;
* the CSTR MPC set up a second time after a bound change
  (examples/CSTR_approximate_mpc/main.py:34-35) takes the new bound, as
  the JAX package's does.
"""
import numpy as np
import pytest
import torch

import jax
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


@pytest.fixture(scope="module")
def mpcs():
    """The oscillating masses' MPC of both packages."""
    return (jdm.systems.oscillating_masses_mpc(
                jdm.systems.oscillating_masses_model()),
            tdm.systems.oscillating_masses_mpc(
                tdm.systems.oscillating_masses_model()))


def _policies(mpcs):
    """(JAX policy, port policy) with the JAX package's initial weights."""
    ja = jdm.approximateMPC.ApproxMPC(mpcs[0])
    tp = tdm.approximateMPC.ApproxMPC(mpcs[1])
    tp.params = jax.tree.map(np.asarray, ja.params)
    return ja, tp


def _data(seed, n=256):
    """tests/test_trainer_dp.py:18-21."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n, 4))
    U_prev = rng.uniform(-0.4, 0.4, (n, 1))
    U = np.clip(-0.3 * X[:, :1] + 0.1 * U_prev, -0.5, 0.5)
    return X, U_prev, U


def test_policy_matches_jax_weights(mpcs):
    ja, tp = _policies(mpcs)
    assert tp.use_u_prev == ja.use_u_prev and tp.n_in == ja.n_in == 5
    for key in ("in_shift", "in_range", "out_shift", "out_range"):
        np.testing.assert_array_equal(getattr(tp, key), getattr(ja, key))
    assert all(p.dtype == torch.float32 for p in tp.net.parameters())
    x = np.random.default_rng(3).uniform(-1.0, 2.0, (64, 5))
    y_j = np.asarray(ja.net.apply(ja.params, x))
    y_t = tp.net(torch.as_tensor(x)).detach().numpy()
    assert y_t.dtype == np.float64 and y_j.dtype == np.float64
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12)
    y_c = tp(ja.params, torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(y_c, y_j, rtol=1e-12, atol=1e-12)
    X, U_prev, _ = _data(4, 8)
    for x0, up in zip(X * 3.0, U_prev * 2.0):
        np.testing.assert_allclose(tp.make_step(x0, u_prev=up),
                                   ja.make_step(x0, u_prev=up),
                                   rtol=1e-12, atol=1e-12)
    # the port's own initialization: flax's lecun-normal kernels (truncated
    # at two standard deviations), zero biases, reproducible
    fresh = tdm.approximateMPC.ApproxMPC(mpcs[1])
    again = tdm.approximateMPC.ApproxMPC(mpcs[1])
    for (name, p), q in zip(fresh.net.named_parameters(),
                            again.net.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
        else:
            bound = 2.0 / 0.87962566103423978 / np.sqrt(p.shape[1])
            assert float(p.detach().abs().max()) <= bound


def test_pickled_policy_loads_across(mpcs, tmp_path):
    ja, tp = _policies(mpcs)
    want = jax.tree.map(np.asarray, ja.params)
    tp.net.layers[0].bias.data.fill_(0.25)     # changed, then overwritten
    ja.save_to_state_dict(str(tmp_path / "jax.pkl"))
    tp.load_from_state_dict(str(tmp_path / "jax.pkl"))
    jax.tree.map(np.testing.assert_array_equal, tp.params, want)
    tp.save_to_state_dict(str(tmp_path / "port.pkl"))
    ja2 = jdm.approximateMPC.ApproxMPC(mpcs[0])
    ja2.params = jax.tree.map(np.zeros_like, want)
    ja2.load_from_state_dict(str(tmp_path / "port.pkl"))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, ja2.params), want)
    assert jax.tree.structure(ja2.params) == jax.tree.structure(ja.params)


def test_trainer_history_matches_jax(mpcs):
    ja, tp = _policies(mpcs)
    hist = []
    for dm, pol in ((jdm, ja), (tdm, tp)):
        st = dm.approximateMPC.TrainerSettings(
            n_epochs=20, batch_size=32, learning_rate=3e-3,
            print_frequency=0, shuffle=True, data_parallel=False)
        X, U_prev, U = _data(0)
        hist.append(dm.approximateMPC.Trainer(pol, st).default_training(
            X, U, U_prev=U_prev, seed=0))
    jh, th = hist
    assert th["lr"] == jh["lr"]
    for key in ("train_loss", "val_loss", "update_norm"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, err_msg=key)
    assert th["train_loss"][-1] < 0.5 * th["train_loss"][0]
    x = np.random.default_rng(5).uniform(0.0, 1.0, (16, 5))
    np.testing.assert_allclose(
        tp.net(torch.as_tensor(x)).detach().numpy(),
        np.asarray(ja.net.apply(ja.params, x)), rtol=1e-4, atol=1e-6)


def test_plateau_scheduler_shrinks_updates(mpcs):
    """tests/test_trainer_dp.py:test_plateau_scheduler_shrinks_updates on
    the port: the scheduler scales the post-Adam update, so each decade of
    learning-rate decay shows up in the update norm."""
    approx = tdm.approximateMPC.ApproxMPC(mpcs[1])
    settings = tdm.approximateMPC.TrainerSettings(
        n_epochs=24, batch_size=64, learning_rate=3e-3,
        print_frequency=0, shuffle=False, data_parallel=False,
        scheduler_flag=True, scheduler_patience=2, scheduler_factor=0.1)
    trainer = tdm.approximateMPC.Trainer(approx, settings)
    rng = np.random.default_rng(1)
    X = rng.uniform(-1.0, 1.0, (256, 4))
    U_prev = rng.uniform(-0.4, 0.4, (256, 1))
    U = rng.uniform(-0.5, 0.5, (256, 1))
    hist = trainer.default_training(X, U, U_prev=U_prev, seed=0)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = trainer.plot_history()
    assert len(ax) == 2
    plt.close(fig)

    lr = np.asarray(hist["lr"])
    norms = np.asarray(hist["update_norm"])
    assert lr[-1] < 0.2 * lr[0], "scheduler never engaged"
    drop_epochs = np.nonzero(lr[1:] < lr[:-1])[0] + 1
    before = norms[:drop_epochs[0]].mean()
    after = norms[-3:].mean()
    assert after < 0.05 * before, (before, after)
    assert lr.min() < lr.max()


def test_sample_open_loop_batched_matches_jax(mpcs, tmp_path):
    """32 samples of a 30 % sub-box (tests/test_satellites.py:91-98) in
    batches of 16: the plans equal, inputs to 1e-8, success flags equal.
    The JAX sampler's u_prev never reaches the solves (the batch solver's
    parameter vector holds the MPC's u0), and the port's matches it: a
    plan with other u_prev gives the same inputs."""
    out = []
    for dm, mpc, sub in ((jdm, mpcs[0], "jax"), (tdm, mpcs[1], "port")):
        st = dm.approximateMPC.AMPCSamplerSettings(
            n_samples=32, data_dir=str(tmp_path / sub))
        sampler = dm.approximateMPC.AMPCSampler(mpc, st)
        x_lb, x_ub = mpc._x_lb.data, mpc._x_ub.data
        plan = sampler.default_sampling_plan(seed=0, lbx=0.3 * x_lb,
                                             ubx=0.3 * x_ub)
        X, U_prev, U, OK = sampler.sample_open_loop_batched(
            plan, batch_size=16, tol=1e-6, max_iter=80)
        out.append((plan, X, U_prev, U, OK, sampler))
    (jplan, jX, jUp, jU, jOK, _), (tplan, tX, tUp, tU, tOK, ts) = out
    for a, b in zip(tplan, jplan):
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["x0"], b["x0"])
        np.testing.assert_array_equal(a["u_prev"], b["u_prev"])
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tUp, jUp)
    np.testing.assert_array_equal(tOK, jOK)
    assert tOK.mean() > 0.9
    np.testing.assert_allclose(tU, jU, rtol=1e-8, atol=1e-8)
    other = [dict(c, u_prev=-c["u_prev"]) for c in tplan[:16]]
    _, Up2, U2, _ = ts.sample_open_loop_batched(other, batch_size=16,
                                                tol=1e-6, max_iter=80)
    np.testing.assert_array_equal(Up2, -tUp[:16])
    np.testing.assert_allclose(U2, tU[:16], rtol=1e-12, atol=1e-12)
    full, opt = ts.save_dataset(tX, tUp, tU, tOK)
    assert opt["x0"].shape[0] == int(tOK.sum())
    loaded = tdm.tools.load_pickle(str(tmp_path / "port"
                                       / "approx_mpc_data_opt"))
    np.testing.assert_array_equal(loaded["u_opt"], opt["u_opt"])


def test_second_setup_takes_the_new_bound():
    """The CSTR MPC at N=3, set up, then T_R's upper bound set to 140 and
    set up again (examples/CSTR_approximate_mpc/main.py:34-35): the decision
    bounds equal the JAX package's and those of an MPC given the bound
    before its first setup, and the solver is rebuilt over them."""
    import __graft_entry__ as ge
    from dompc_tpu_torch.systems import cstr_robust_mpc
    jm = ge._build_cstr_mpc(n_horizon=3)
    tm = cstr_robust_mpc(n_horizon=3)
    first = tm._solve_raw
    for mpc in (jm, tm):
        mpc.bounds["upper", "_x", "T_R"] = 140.0
        mpc.setup()
    assert tm._solve_raw is not first
    for key in ("_lb_opt_x", "_ub_opt_x"):
        np.testing.assert_array_equal(getattr(tm, key), getattr(jm, key))
    assert (tm.n_opt_x, tm.n_opt_lagr, tm._n_ineq) == \
        (jm.n_opt_x, jm.n_opt_lagr, jm._n_ineq)
    assert np.isin(140.0 / 100.0, tm._ub_opt_x)
    approx = tdm.approximateMPC.ApproxMPC(tm)
    assert approx.in_shift[2] == 50.0 and approx.in_range[2] == 90.0
