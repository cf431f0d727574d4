"""OPC UA server (reference: do_mpc/opcua/_server.py:82-109)."""
from __future__ import annotations

from asyncua.sync import Server


class RTServer:
    def __init__(self, opts):
        self.name = opts.name
        self.address = f"opc.tcp://{opts.address}:{opts.port}/"
        self.opcua_server = Server()
        self.opcua_server.set_endpoint(self.address)
        self.namespace_dict = {}

    def namespace_from_client(self, client_wrapper):
        """Register a client's namespace on the server: one object node per
        variable group, one variable node per element
        (reference: _server.py:82-109)."""
        namespace = client_wrapper.client.namespace_list[0] \
            if hasattr(client_wrapper, "client") else client_wrapper
        idx = self.opcua_server.register_namespace(namespace.namespace_name)
        namespace.namespace_index = idx
        objects = self.opcua_server.nodes.objects
        node_cache = {}
        for entry in namespace.entry_list:
            if entry.objectnode not in node_cache:
                node_cache[entry.objectnode] = objects.add_object(
                    idx, entry.objectnode)
            var_node = node_cache[entry.objectnode].add_variable(
                entry.get_node_id(idx), entry.variable, 0.0)
            var_node.set_writable()
        self.namespace_dict[namespace.namespace_name] = namespace

    def start(self):
        self.opcua_server.start()

    def stop(self):
        self.opcua_server.stop()
