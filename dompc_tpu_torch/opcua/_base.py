"""Real-time wrapper turning any do-mpc-style object of the port (MPC,
Simulator, MHE, ...) into an OPC UA client node (reference:
do_mpc/opcua/_base.py:92-257; port of the JAX package's
``opcua/_base.py``)."""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ._helper import Namespace, NamespaceEntry


def _host(data):
    """An output of ``make_step`` (numpy, a NumStruct or a tensor on any
    device) as a flat float numpy vector."""
    if hasattr(data, "data"):            # NumStruct
        data = data.data
    if torch.is_tensor(data):
        data = data.detach().to("cpu", torch.float64).numpy()
    return np.asarray(data, dtype=float).reshape(-1)


class RTBase:
    """Wraps ``do_mpc_object.make_step`` for distributed real-time loops:
    read inputs from the server, step, write outputs back; periodic
    execution in a thread (reference async_step_start, _base.py:230-248).
    Tags carry floats; ``make_step`` gets numpy and its output goes back to
    the tags as numpy, whatever device the object computes on."""

    def __init__(self, do_mpc_object, clientOpts, namespace=None,
                 client_factory=None):
        self.do_mpc_object = do_mpc_object
        if namespace is None:
            self.namespace_from_model()
        else:
            self.def_namespace = namespace
        self.cycle_time = do_mpc_object.settings.t_step * clientOpts.timeunit
        if client_factory is None:
            # asyncua is an optional dependency; resolve it only when a
            # real network client is requested, so the namespace / tag
            # plumbing works without the network stack
            from ._client import RTClient as client_factory
        self.client = client_factory(clientOpts, self.def_namespace)
        self.tagout = []
        self.tagin = []
        self.is_running = False
        self.new_init = True

    def namespace_from_model(self):
        """Derive the namespace entries from the model variables
        (reference: _base.py:92-118)."""
        model = self.do_mpc_object.model
        object_name = type(self.do_mpc_object).__name__
        entries = []
        for vt in ("_x", "_u", "_z", "_p", "_tvp", "_y", "_aux", "_w", "_v"):
            spec = model.spec(vt)
            for name in spec.names:
                for i in range(spec.block_size(name)):
                    entries.append(NamespaceEntry(vt, f"{name}[{i}]"))
        self.def_namespace = Namespace(object_name, entries)

    def connect(self):
        self.client.connect()

    def disconnect(self):
        self.client.disconnect()

    def set_write_tags(self, tagout):
        self.tagout = tagout

    def set_read_tags(self, tagin):
        self.tagin = tagin

    def read_from_tags(self):
        """Read the registered input tags from the server as an (n, 1)
        float vector (reference: _base.py:210-217)."""
        return np.array([self.client.readData(t)
                         for t in self.tagin], dtype=float).reshape(-1, 1)

    def write_to_tags(self, data):
        """Write an output vector to the registered output tags
        (reference: _base.py:185-207)."""
        data = _host(data)
        if data.size != len(self.tagout):
            raise RuntimeError(
                f"Trying to write {data.size} elements to "
                f"{len(self.tagout)} tags")
        for tag, val in zip(self.tagout, data):
            self.client.writeData(tag, float(val))

    def make_step(self):
        """One distributed step: read -> make_step -> write
        (reference: _base.py:175-183)."""
        input_val = self.read_from_tags()
        output = self.do_mpc_object.make_step(input_val)
        self.write_to_tags(output)

    def async_step_start(self):
        if self.new_init:
            self.new_thread = threading.Thread(target=self.async_run)
            self.new_thread.start()
            self.new_init = False

    def async_run(self):
        self.is_running = True
        while self.is_running:
            t0 = time.time()
            self.make_step()
            dt = self.cycle_time - (time.time() - t0)
            if dt > 0:
                time.sleep(dt)

    def async_step_stop(self):
        self.is_running = False
        self.new_init = True
