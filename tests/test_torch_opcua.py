"""``opcua`` of the PyTorch port against the JAX package's (CPU, float64),
the cases of tests/test_opcua.py: the namespace / tag plumbing with a
dict-backed client in place of the OPC UA server.

* namespace entries equal to JAX's for the same Simulator and MPC;
* the ``RTBase`` round trip against a direct ``Simulator`` step (1e-12);
* the size-mismatch error and the threaded periodic loop;
* an MPC node and a Simulator node exchanging tags for 3 cycles against
  the JAX package's direct loop (1e-8);
* the live loopback over a real OPC UA server needs asyncua and skips
  without it, as in the JAX package.
"""
import time

import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu.systems  # noqa: F401
import dompc_tpu.opcua as jopcua
import dompc_tpu_torch as tdm
from dompc_tpu_torch.opcua import ClientOpts, RTBase

X0 = np.array([2.0, 1.0, 0.0, 0.0])


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def fake_client(store):
    """A client factory whose clients read and write ``store`` (no
    network)."""
    class FakeClient:
        def __init__(self, opts, namespace):
            self.opts = opts
            self.namespace_list = [namespace]
            self.connected = False

        def connect(self):
            self.connected = True

        def disconnect(self):
            self.connected = False

        def writeData(self, tag, value):
            store[tag] = value

        def readData(self, tag):
            return store[tag]
    return FakeClient


def _opts(name="test_client"):
    return ClientOpts(name, "localhost", 4840, timeunit=1.0)


def _sim(dm, t_step=0.5):
    sim = dm.Simulator(dm.systems.oscillating_masses_model())
    sim.set_param(t_step=t_step)
    sim.setup()
    return sim


def test_namespace_matches_jax():
    jmodel = jdm.systems.oscillating_masses_model()
    tmodel = tdm.systems.oscillating_masses_model()
    pairs = []
    for dm, mod, model in ((jdm, jopcua, jmodel), (tdm, tdm.opcua, tmodel)):
        sim = dm.Simulator(model)
        sim.set_param(t_step=0.5)
        sim.setup()
        mpc = dm.systems.oscillating_masses_mpc(model)
        pairs.append([mod.RTBase(obj, mod.ClientOpts("c", "localhost", 1),
                                 client_factory=fake_client({}))
                      for obj in (sim, mpc)])
    for rj, rt in zip(*pairs):
        assert rt.def_namespace.namespace_name == \
            rj.def_namespace.namespace_name
        assert [(e.objectnode, e.variable) for e in
                rt.def_namespace.entry_list] == \
            [(e.objectnode, e.variable) for e in rj.def_namespace.entry_list]
        assert rt.cycle_time == rj.cycle_time == 0.5
    assert tdm.opcua.RTClient is None and tdm.opcua.RTServer is None


def test_rtbase_make_step_roundtrip():
    store = {}
    sim = _sim(tdm)
    x0 = np.array([0.2, -0.1, 0.3, 0.0])
    sim.x0 = x0
    rt = RTBase(sim, _opts(), client_factory=fake_client(store))
    rt.connect()
    assert rt.client.connected
    rt.set_read_tags(["ns=1;s=MPC[u[0]]"])
    rt.set_write_tags([f"ns=1;s=Simulator[y[{i}]]" for i in range(4)])
    store["ns=1;s=MPC[u[0]]"] = 0.25
    rt.make_step()
    y = np.array([store[f"ns=1;s=Simulator[y[{i}]]"] for i in range(4)])
    assert all(isinstance(store[f"ns=1;s=Simulator[y[{i}]]"], float)
               for i in range(4))
    sim2 = _sim(tdm)
    sim2.x0 = x0
    y_ref = sim2.make_step(np.array([[0.25]])).reshape(-1)
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    rt.disconnect()
    assert not rt.client.connected


def test_rtbase_write_size_mismatch():
    rt = RTBase(_sim(tdm), _opts(), client_factory=fake_client({}))
    rt.set_write_tags(["a", "b"])
    with pytest.raises(RuntimeError):
        rt.write_to_tags(np.zeros(3))
    with pytest.raises(RuntimeError):
        rt.write_to_tags(torch.zeros(3, 1))


def test_rtbase_async_loop():
    store = {"ns=1;s=MPC[u[0]]": 0.0}
    sim = _sim(tdm, t_step=0.02)
    sim.x0 = np.zeros(4)
    rt = RTBase(sim, _opts(), client_factory=fake_client(store))
    rt.set_read_tags(["ns=1;s=MPC[u[0]]"])
    rt.set_write_tags([f"ns=1;s=Simulator[y[{i}]]" for i in range(4)])
    rt.async_step_start()
    deadline = time.time() + 10.0
    while sim.data._y.shape[0] < 2 and time.time() < deadline:
        time.sleep(0.02)
    rt.async_step_stop()
    rt.new_thread.join(timeout=10.0)
    assert not rt.new_thread.is_alive()
    assert sim.data._y.shape[0] >= 2


def test_node_loop_matches_jax_direct_loop():
    """tests/test_opcua.py:test_live_loopback_mpc_simulator's loop with the
    dict store in place of the server: the port's nodes against the JAX
    package's direct in-process loop."""
    n_cycles = 3
    jmodel = jdm.systems.oscillating_masses_model()
    mpc_d = jdm.systems.oscillating_masses_mpc(jmodel)
    sim_d = jdm.Simulator(jmodel)
    sim_d.set_param(t_step=0.5)
    sim_d.setup()
    mpc_d.x0 = X0
    sim_d.x0 = X0
    mpc_d.set_initial_guess()
    xk = X0
    for _ in range(n_cycles):
        xk = sim_d.make_step(mpc_d.make_step(xk)).reshape(-1)

    store = {}
    mpc_n = tdm.systems.oscillating_masses_mpc(
        tdm.systems.oscillating_masses_model())
    sim_n = _sim(tdm)
    mpc_n.x0 = X0
    sim_n.x0 = X0
    mpc_n.set_initial_guess()
    rt_mpc = RTBase(mpc_n, _opts("mpc"), client_factory=fake_client(store))
    rt_sim = RTBase(sim_n, _opts("sim"), client_factory=fake_client(store))
    for rt, idx in ((rt_mpc, 1), (rt_sim, 2)):
        rt.def_namespace.namespace_index = idx
    # the plant's measurements (named x, as the states and the measurement
    # noise: the namespace's lookup by variable name gives all three, so
    # select the _y object node)
    x_tags = [e.get_node_id(2) for e in rt_sim.def_namespace.entry_list
              if e.objectnode == "_y"]
    u_tags = rt_mpc.def_namespace["u[0]"]
    assert u_tags == ["ns=1;s=_u[u[0]]"]
    assert x_tags == [f"ns=2;s=_y[x[{i}]]" for i in range(4)]
    assert rt_sim.def_namespace["x[0]"] == [
        "ns=2;s=_x[x[0]]", "ns=2;s=_y[x[0]]", "ns=2;s=_v[x[0]]"]
    rt_mpc.set_read_tags(x_tags)
    rt_mpc.set_write_tags(u_tags)
    rt_sim.set_read_tags(u_tags)
    rt_sim.set_write_tags(x_tags)
    rt_sim.write_to_tags(X0)
    for _ in range(n_cycles):
        rt_mpc.make_step()
        rt_sim.make_step()
    np.testing.assert_allclose(mpc_n.data._u, mpc_d.data._u,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sim_n.data._x, sim_d.data._x,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose([store[t] for t in x_tags], xk,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_live_loopback_needs_asyncua():
    """The live loopback over a real local server (tests/test_opcua.py:
    test_live_loopback_mpc_simulator) needs asyncua, absent here."""
    pytest.importorskip("asyncua")
    assert tdm.opcua.RTServer is not None and tdm.opcua.RTClient is not None
