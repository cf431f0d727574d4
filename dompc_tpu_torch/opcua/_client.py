"""OPC UA client (reference: do_mpc/opcua/_client.py:29-144)."""
from __future__ import annotations

from asyncua.sync import Client


class RTClient:
    def __init__(self, opts, write_namespace):
        self.server_address = f"opc.tcp://{opts.address}:{opts.port}/"
        self.name = opts.name
        self.namespace_list = [write_namespace]
        self.client = Client(self.server_address)

    def connect(self):
        self.client.connect()

    def disconnect(self):
        self.client.disconnect()

    def register_namespace_from_client(self, other_client):
        """Adopt another client's namespace (indices resolved live)."""
        self.namespace_list += other_client.client.namespace_list

    def get_namespace_index(self, namespace_name):
        uri = namespace_name
        return self.client.get_namespace_index(uri)

    def writeData(self, tag, value):
        node = self.client.get_node(tag)
        node.set_value(value)

    def readData(self, tag):
        node = self.client.get_node(tag)
        return node.get_value()
