"""OPC UA dataclass options and namespace description
(reference: do_mpc/opcua/_helper.py:26-117)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ServerOpts:
    name: str
    address: str
    port: int


@dataclass
class ClientOpts:
    name: str
    address: str
    port: int
    timeunit: float = 1.0  # seconds per t_step unit


@dataclass
class NamespaceEntry:
    objectnode: str
    variable: str

    def get_node_id(self, namespace_index):
        return f"ns={namespace_index};s={self.objectnode}[{self.variable}]"


@dataclass
class Namespace:
    namespace_name: str
    entry_list: List[NamespaceEntry] = field(default_factory=list)
    _namespace_index: int | None = None

    def add_entries(self, entries):
        self.entry_list.extend(entries)

    def has_entry(self, entry):
        return entry in self.entry_list

    @property
    def namespace_index(self):
        return self._namespace_index

    @namespace_index.setter
    def namespace_index(self, val):
        self._namespace_index = val

    def __getitem__(self, variable_name):
        return [e.get_node_id(self._namespace_index) for e in self.entry_list
                if e.variable == variable_name]
